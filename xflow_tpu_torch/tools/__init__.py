"""Tools of the port: the sparse-primitive lab (`bench_lab`) and the
on-device kernel parity gate (`kernel_parity`)."""

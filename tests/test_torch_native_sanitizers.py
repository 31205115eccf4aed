"""PyTorch port, the sanitizer builds of the native data plane
(`XFLOW_NATIVE_SANITIZE`, `xflow_tpu_torch/data/native.py`), after
`tests/test_native_sanitizers.py`: the port's parser.cc rebuilt under
TSan and under ASan+UBSan runs the multithreaded parser against the
sequential one in a subprocess with the sanitizer runtime preloaded and
halt_on_error set, so a data race, a heap error or undefined behaviour
fails the run; its batches also equal the JAX package's plain native
parser's. Skips where the toolchain lacks the runtime.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from xflow_tpu.config import DataConfig as JDataConfig
from xflow_tpu.data.native import native_batch_iterator as jnative_batches
from xflow_tpu_torch.data.synth import generate_shards

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 4096  # many blocks a file: the MT pool's hand-offs run


def _runtime_for(sanitize: str):
    lib = "libtsan.so" if sanitize.startswith("thread") else "libasan.so"
    try:
        out = subprocess.run(["gcc", f"-print-file-name={lib}"], capture_output=True,
                             text=True).stdout.strip()
    except FileNotFoundError:
        return None
    return out if out and os.path.isabs(out) and os.path.exists(out) else None


PROBE = textwrap.dedent(f"""
    import sys
    import numpy as np
    import xflow_tpu_torch.data.native as native
    from xflow_tpu_torch.config import Config, override
    native.BLOCK_BYTES = {BLOCK}
    path, out = sys.argv[1], sys.argv[2]
    def cfg(threads):
        return override(Config(), **{{"data.log2_slots": 16, "data.max_nnz": 10,
                                      "data.parser_threads": threads}}).data
    a = list(native.native_batch_iterator(path, cfg(1), 64))
    b = list(native.native_batch_iterator(path, cfg(4), 64))
    assert len(a) == len(b) and len(a) > 0, (len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        # plain compares: numpy.testing imported lazily under a preloaded
        # TSan can deadlock
        for field in ("slots", "fields", "mask", "labels", "row_mask"):
            assert (getattr(x, field) == getattr(y, field)).all(), (i, field)
    assert native.native_count_rows(path) == sum(int(x.row_mask.sum()) for x in a)
    np.savez(out, **{{f"{{f}}_{{i}}": getattr(x, f) for i, x in enumerate(b)
                     for f in ("slots", "fields", "mask", "labels", "row_mask")}})
    print("SANITIZED_PARITY_OK", len(a))
""")


@pytest.mark.parametrize("sanitize", ["thread", "address,undefined"])
def test_port_mt_parser_under_sanitizer(tmp_path, sanitize):
    runtime = _runtime_for(sanitize)
    if runtime is None:
        pytest.skip(f"no sanitizer runtime for -fsanitize={sanitize}")
    (path,) = generate_shards(str(tmp_path / "train"), 1, 700, num_fields=7,
                              ids_per_field=40, seed=3)
    probe = tmp_path / "probe.py"
    probe.write_text(PROBE)
    env = {k: v for k, v in os.environ.items() if not k.startswith("XFLOW_")}
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["XFLOW_NATIVE_SANITIZE"] = sanitize
    # build first without the preload (g++ under a preloaded runtime can
    # hang); the flag is in the digest, so the probe loads this build
    build = subprocess.run(
        [sys.executable, "-c",
         "from xflow_tpu_torch.data.native import _build_lib; print(_build_lib())"],
        capture_output=True, text=True, env=env, timeout=300)
    assert build.returncode == 0, f"sanitized build failed:\n{build.stderr}"
    assert os.path.basename(build.stdout.strip()).startswith("libxfparser_")
    env["LD_PRELOAD"] = runtime
    env["ASAN_OPTIONS"] = "detect_leaks=0:halt_on_error=1:exitcode=66"
    env["TSAN_OPTIONS"] = "halt_on_error=1:exitcode=66"
    out = tmp_path / "batches.npz"
    r = subprocess.run([sys.executable, str(probe), path, str(out)], capture_output=True,
                       text=True, env=env, timeout=600)
    if r.returncode != 0 and "cannot be preloaded" in (r.stderr or ""):
        pytest.skip(f"sanitizer runtime not preloadable: {runtime}")
    assert r.returncode == 0, (f"-fsanitize={sanitize} run failed (rc={r.returncode})\n"
                               f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}")
    assert "SANITIZED_PARITY_OK" in r.stdout, r.stdout
    want = list(jnative_batches(path, JDataConfig(log2_slots=16, max_nnz=10,
                                                  parser_threads=4, block_bytes=BLOCK), 64))
    with np.load(out) as z:
        for i, x in enumerate(want):
            for f in ("slots", "fields", "mask", "labels", "row_mask"):
                np.testing.assert_array_equal(z[f"{f}_{i}"], getattr(x, f), err_msg=(i, f))
        assert len(z.files) == 5 * len(want)


def test_sanitize_flag_joins_the_build_and_its_digest(monkeypatch):
    from xflow_tpu_torch.data import native

    monkeypatch.delenv("XFLOW_NATIVE_SANITIZE", raising=False)
    plain = native.build_flags()
    assert not any(f.startswith("-fsanitize") for f in plain)
    monkeypatch.setenv("XFLOW_NATIVE_SANITIZE", "thread")
    assert native.build_flags() == ["-fsanitize=thread", "-g", "-fno-omit-frame-pointer",
                                    *plain]

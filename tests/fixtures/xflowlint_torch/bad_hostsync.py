"""XF110/XF111 fixture for the PyTorch port's host-sync pass (never run).

Each line whose comment names XF110 or XF111 blocks the hot loop on a
device value dispatched in the SAME iteration: the sync bubble the
one-step-behind discipline exists to remove. The lines whose comment
says "silent" must stay silent: the staged read one step behind (a newer
dispatch has aged it), the non-blocking copy into a pinned buffer, the
shape and length reads (metadata), and the reads of a loop that
dispatches nothing.
"""

import numpy as np
import torch


class _Trainer:
    def _fit(self, batches, device):
        state = object()
        staged = None
        pinned = torch.empty(4, pin_memory=True)
        for batch in batches:
            arrays = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
            state, m = self.train_step(state, arrays)
            loss = m["loss"].item()  # XF110: same-iteration loss read
            print(m["rows"])  # XF110: print forces the transfer
            if m["update_ok"]:  # XF111: implicit bool sync in a branch
                continue
            note = f"grad={m['grad_norm']}"  # XF110: f-string interpolation
            ok = bool(torch.isfinite(m["loss"]))  # XF110: a torch function of it
            self.log(loss, note, ok)
            host = m["norms"].cpu()  # XF110: .cpu() blocks
            vals = m["norms"].to("cpu")  # XF110: a blocking copy to the host
            self.log(host, vals, m["norms"].tolist())  # XF110: .tolist() blocks
            torch.cuda.synchronize()  # XF110: drains the stream
            pinned.copy_(m["norms"].to("cpu", non_blocking=True))  # silent: pinned copy
            rows = m["logits"].shape[0] + len(m["logits"])  # silent: metadata
            self.log(rows)
            # one behind: staged LAST iteration, aged by this iteration's
            # dispatch; reading it here is the discipline itself
            if staged is not None:
                self.emit(float(staged["loss"]))  # silent: the one-behind read
            staged = m
        # post-run epilogue: this loop dispatches nothing, so its reads
        # are mandatory one-time syncs, not bubbles
        for key in ("loss", "rows"):
            self.emit(float(m[key]))  # silent: a read-only loop


class _Server:
    def __init__(self, make_step):
        self.eval_step = make_step()
        self.out = []

    def _worker_loop(self):
        done = torch.cuda.Event()
        side = torch.cuda.Stream()
        while True:
            group = self.take()
            p = self.eval_step(group)
            done.record()
            self.out.append(np.asarray(p))  # XF110: same-iteration readback
            done.synchronize()  # XF110: an event recorded this iteration
            side.synchronize()  # XF110: a stream's synchronize
            torch.cuda.current_stream().synchronize()  # XF110: the current stream's
            for x in p:  # XF111: iterating a device tensor
                self.out.append(x)
            if p.sum() > 0:  # XF111: a branch on the batch
                break


def prefetch(iterator, q, device):
    for item in iterator:
        dev = item.to(device)
        q.put(int(dev[0]))  # XF110: int() blocks on the fresh transfer
        buf = torch.zeros(8, device="cuda")
        assert buf.max() < 1  # XF111: an assert on a card factory's tensor

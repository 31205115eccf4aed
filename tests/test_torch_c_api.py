"""PyTorch port, the C ABI (`xflow_tpu_torch/c_api/`) on the CPU, after
`tests/test_c_api.py`: a real C client compiled against the port's shim
trains, evaluates, loads the committed checkpoint and predicts through
`XFSetConfig(h, "device", "cpu")`; a predict before a load and a
malformed row return -1. A predict-only client linked in turn against
each package's shim reads the same checkpoint to pCTRs within 1e-5, and
the port's shim embeds no JAX.
"""

import os
import re
import shutil
import subprocess
import sysconfig

import pytest

from xflow_tpu_torch.data.synth import generate_shards

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None, reason="no gcc")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIMS = {"torch": os.path.join(REPO, "xflow_tpu_torch", "c_api"),
         "jax": os.path.join(REPO, "xflow_tpu", "c_api")}
PCTR_ATOL = 1e-5

CLIENT = r"""
#include <stdio.h>
#include <string.h>
#include "xflow_c_api.h"

/* argv: train_prefix test_prefix checkpoint_dir
 * Full lifecycle on the CPU: train -> checkpoint -> load -> predict. */
int main(int argc, char** argv) {
  void* h = 0;
  if (XFCreate(&h, argv[1], argv[2]) != 0) return 2;
  if (XFSetConfig(h, "device", "cpu") != 0) return 3;
  if (XFSetConfig(h, "train.epochs", "4") != 0) return 3;
  if (XFSetConfig(h, "data.batch_size", "64") != 0) return 3;
  if (XFSetConfig(h, "data.log2_slots", "12") != 0) return 3;
  if (XFSetConfig(h, "model.num_fields", "5") != 0) return 3;
  if (XFSetConfig(h, "train.pred_dump", "false") != 0) return 3;
  if (XFSetConfig(h, "train.checkpoint_dir", argv[3]) != 0) return 3;
  if (XFStartTrain(h) != 0) return 4;
  double auc = XFGetAUC(h);
  printf("AUC=%.4f\n", auc);
  if (auc <= 0.7) return 5;

  /* predicting before a load must fail cleanly, not crash */
  double pre[1];
  if (XFPredict(h, "0:a 1:b", pre, 1) != -1) return 6;

  if (XFLoadCheckpoint(h, argv[3]) != 0) return 7;
  double p[4];
  int n = XFPredict(h, "0:f0x 1:f1y 2:f2z\n1\t0:q 3:r\n4:s", p, 4);
  if (n != 3) { printf("XFPredict wrote %d rows, want 3\n", n); return 8; }
  for (int i = 0; i < 3; ++i) {
    printf("PCTR=%.6f\n", p[i]);
    if (!(p[i] > 0.0 && p[i] < 1.0)) return 9;
  }
  /* a malformed row errors (the quarantine philosophy), never crashes */
  if (XFPredict(h, "no-colon-tokens", p, 4) != -1) return 10;
  XFDestroy(h);
  return 0;
}
"""

PREDICT_CLIENT = r"""
#include <stdio.h>
#include "xflow_c_api.h"

/* argv: checkpoint_dir [key value]...: load and predict four rows */
int main(int argc, char** argv) {
  void* h = 0;
  if (XFCreate(&h, "", "") != 0) return 2;
  for (int i = 2; i + 1 < argc; i += 2)
    if (XFSetConfig(h, argv[i], argv[i + 1]) != 0) return 3;
  if (XFLoadCheckpoint(h, argv[1]) != 0) return 7;
  double p[4];
  int n = XFPredict(h, "0:f0x 1:f1y 2:f2z\n1\t0:q 3:r\n4:s\n0:a 1:b 2:c 3:d 4:e", p, 4);
  if (n != 4) return 8;
  for (int i = 0; i < n; ++i) printf("PCTR=%.9f\n", p[i]);
  XFDestroy(h);
  return 0;
}
"""


def _build(tmp_path, name, source, shim):
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var("VERSION")
    src = tmp_path / f"{name}.c"
    src.write_text(source)
    exe = tmp_path / name
    subprocess.run(["gcc", str(src), os.path.join(SHIMS[shim], "xflow_c_api.c"),
                    f"-I{SHIMS[shim]}", f"-I{inc}", f"-L{libdir}", f"-lpython{ver}",
                    f"-Wl,-rpath,{libdir}", "-o", str(exe)], check=True, capture_output=True)
    return exe


def _run(exe, args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XFLOW_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([str(exe), *args], capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=600)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("c_api")
    generate_shards(str(tmp / "train"), 1, 800, num_fields=5, ids_per_field=30, seed=0,
                    noise=0.3)
    exe = _build(tmp, "client", CLIENT, "torch")
    # evaluate on the train shard: the gate is that embedding works
    r = _run(exe, [str(tmp / "train"), str(tmp / "train"), str(tmp / "ckpt")], tmp)
    return tmp, r


def test_c_client_trains_loads_and_predicts_on_the_cpu(trained):
    _, r = trained
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr)
    assert r.stdout.startswith("AUC=")
    assert r.stdout.count("PCTR=") == 3, r.stdout


def test_port_shim_predicts_as_the_jax_shim_on_one_checkpoint(trained):
    tmp, r = trained
    assert r.returncode == 0, r.stderr
    keys = ["data.log2_slots", "12", "model.num_fields", "5"]
    got = {}
    for shim in SHIMS:
        exe = _build(tmp, f"predict_{shim}", PREDICT_CLIENT, shim)
        extra = ["device", "cpu"] if shim == "torch" else []
        out = _run(exe, [str(tmp / "ckpt"), *keys, *extra], tmp)
        assert out.returncode == 0, (shim, out.stdout, out.stderr)
        got[shim] = [float(v) for v in re.findall(r"PCTR=([0-9.]+)", out.stdout)]
    assert len(got["torch"]) == len(got["jax"]) == 4
    assert got["torch"] == pytest.approx(got["jax"], abs=PCTR_ATOL)


def test_port_shim_embeds_no_jax(trained, tmp_path):
    """The port's shim with jax and xflow_tpu blocked: a blocking package
    first on PYTHONPATH."""
    tmp, r = trained
    assert r.returncode == 0, r.stderr
    block = tmp_path / "block"
    for name in ("jax", "xflow_tpu"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(f"raise ImportError('{name} is blocked')\n")
    exe = _build(tmp_path, "predict_blocked", PREDICT_CLIENT, "torch")
    out = _run(exe, [str(tmp / "ckpt"), "data.log2_slots", "12", "model.num_fields", "5",
                     "device", "cpu"], tmp_path,
               {"PYTHONPATH": os.pathsep.join([str(block), REPO])})
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert out.stdout.count("PCTR=") == 4


def test_cuda_is_the_default_device():
    from xflow_tpu_torch.c_api import embed

    h = embed.create("a", "b")
    try:
        assert embed._registry[h]["device"] == "cuda"
        embed.set_config(h, "device", "cpu")
        embed.set_config(h, "model.name", "fm")
        assert embed._registry[h]["device"] == "cpu"
        assert "device" not in embed._registry[h]["overrides"]
        assert embed.get_serving_step(h) == -1
    finally:
        embed.destroy(h)

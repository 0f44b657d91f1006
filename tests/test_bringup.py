"""Device-facing plumbing that the CPU can check: the peak table, the
compile-cache placement and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from cmusphinx_tpu.utils import mfu
from cmusphinx_tpu.utils.compile_cache import CHECKOUT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_update, cwd=ROOT):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **env_update)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_device_peaks_by_kind():
    h100 = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert mfu.device_peaks(h100).bf16 == 989e12
    assert mfu.device_peaks(SimpleNamespace(platform="cpu",
                                            device_kind="cpu")) is None
    with pytest.raises(KeyError, match="NVIDIA A100"):
        mfu.device_peaks(SimpleNamespace(platform="gpu",
                                         device_kind="NVIDIA A100-SXM4-80GB"))


def test_report_prints_utilization_only_with_peaks():
    st = [mfu.Stage("gemm", 0.002, flops=2e12, bytes=1e9)]
    assert "MFU" not in mfu.report(st, None)
    table = mfu.report(st, mfu.PEAKS["NVIDIA H100 80GB HBM3"])
    assert "MFU" in table and "| 101.112% |" in table      # 1 PF/s / 989 TF


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(env_dir, tmp_path):
    code = ("import jax\n"
            "from cmusphinx_tpu.utils.compile_cache import "
            "init_compile_cache\n"
            "print(init_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    update = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    out = _run(["-c", code], update)
    assert out.returncode == 0, out.stderr
    want = str(tmp_path) if env_dir else os.path.join(CHECKOUT, ".jax_cache")
    assert out.stdout.split() == [want, want]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = _run(["chip_smoke.py"], {}, cwd=cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

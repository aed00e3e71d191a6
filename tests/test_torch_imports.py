"""Guards for the port's boundaries: it never imports JAX or the JAX
package, and its entry points never fall back to the CPU on their own."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
# the port's paper benchmarks (benchmarks/torch_*.py that a CPU test imports)
BENCHMARKS = ["benchmarks.torch_paper_repro", "benchmarks.torch_speedup"]


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    """Every port module, chip_smoke.py and the port's paper benchmarks
    import in a process where ``jax`` and ``repro`` cannot be imported at
    all."""
    mods = _port_modules()
    assert ("repro_torch.configs.lenet300" in mods
            and "repro_torch.core.policy" in mods)
    assert "repro_torch.serve.engine" in mods and "repro_torch.convert" in mods
    assert "repro_torch.train.loop" in mods and "repro_torch.data.pipeline" in mods
    assert ("repro_torch.dist.compress" in mods
            and "repro_torch.dist.microbatch" in mods)
    assert ("repro_torch.checkpoint.checkpoint" in mods
            and "repro_torch.kernels.fused_ffn" in mods)
    assert ("repro_torch.kernels.paged_attention" in mods
            and "repro_torch.serve.sampling" in mods
            and "repro_torch.launch.serve" in mods)
    assert ("repro_torch.serve.resilience" in mods
            and "repro_torch.serve.server" in mods
            and "repro_torch.serve.router" in mods)
    assert ("repro_torch.models.moe" in mods
            and "repro_torch.configs.qwen2_moe_a2_7b" in mods)
    assert ("repro_torch.models.rwkv" in mods
            and "repro_torch.models.mamba" in mods
            and "repro_torch.configs.rwkv6_3b" in mods
            and "repro_torch.configs.jamba_v0_1_52b" in mods)
    code = (
        "import sys, importlib\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]\n"
        f"for name in {mods!r} + {BENCHMARKS!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.kernels import paged_attention, ops, ref, _build\n"
        "from repro_torch.serve import sampling, cache\n"
        "assert callable(paged_attention.paged_attention_verify)\n"
        "assert callable(ops.paged_attention_verify)\n"
        "assert callable(ref.paged_attention_verify_ref)\n"
        "assert 'paged_verify' in _build.SOURCES\n"
        "assert callable(sampling.spec_accept) and callable(cache.share_trie)\n"
        "from repro_torch.serve import resilience, server\n"
        "assert callable(server.run) and resilience.storm_schedule()\n"
        "from repro_torch.serve import Handoff, Router, RouterMetrics\n"
        "assert callable(Router.step) and RouterMetrics([]).summary\n"
        "from repro_torch.data import TeacherStudent\n"
        "from repro_torch.core.policy import uniform\n"
        "assert TeacherStudent().next()['inputs'].shape == (50, 800)\n"
        "assert uniform(10, min_block=1).c == 10\n"
        "leaked = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "          or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in leaked), leaked\n"
        "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)"
    r"|from\s+repro(\.|\s)(?!_torch))", re.M)


def test_no_jax_or_repro_imports_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / (m.replace(".", "/") + ".py") for m in BENCHMARKS]
    assert len(files) > 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders


def test_entry_points_refuse_cpu_without_asking(monkeypatch):
    """Without a card and without ``device="cpu"`` the entry points raise
    instead of running on the host."""
    from repro_torch import device as device_lib
    from repro_torch.configs.common import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(get_config("olmo-1b", smoke=True))
    with pytest.raises(device_lib.NoCudaDevice):
        model.init(0)
    with pytest.raises(device_lib.NoCudaDevice):
        model.init_paged_caches(2, 4, 8)
    with pytest.raises(device_lib.NoCudaDevice):
        device_lib.resolve("cuda")
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--arch", "olmo-1b", "--smoke", "--paged"])
    assert model.init(0, device="cpu")["embed"]["table"].device.type == "cpu"


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA device, and in a directory holding nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           text=True, timeout=300, cwd=cwd, env=env)
        assert r.returncode != 0, r.stdout
        assert '"ok": true' not in r.stdout

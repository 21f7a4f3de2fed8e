"""The port stands alone: no jax, nothing of repro, and no silent CPU.

``src/repro_torch``, ``chip_smoke.py`` and ``scripts/`` import neither ``jax`` nor any
module of the reference package ``repro``; the port imports with jax
made unimportable; and its entry points refuse to run without a card
unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_and_no_reference_imports():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("*.py")))
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_port_imports_with_jax_unimportable():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.bridge\n"
            "import repro_torch.serve.spec, repro_torch.serve.draft\n"
            "import repro_torch.kernels.rms_norm\n"
            "import repro_torch.obs, repro_torch.obs.__main__\n"
            "import repro_torch.serve.scheduler, repro_torch.serve.loadgen\n"
            "import repro_torch.serve.faults, repro_torch.serve.instrument\n"
            "import repro_torch.dist.checkpoint, repro_torch.dist._tree\n"
            "import repro_torch.train, repro_torch.train.grad_compress\n"
            "import repro_torch.launch.train, repro_torch.launch.quantize\n"
            "import repro_torch.core.theory\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules), 'imported repro'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine

    model = build_model(ARCHS["llama3-8b"].tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--tiny", "--requests", "1"])
    from repro_torch.launch import quantize as launch_quantize
    from repro_torch.launch import train as launch_train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_quantize.main(["--tiny"])


def test_engine_rejects_params_on_another_device():
    from repro_torch.configs import ARCHS
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine

    model = build_model(ARCHS["llama3-8b"].tiny())
    params = model.init(0, device="cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(model, params, device="cpu")


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """Without CUDA (here) chip_smoke exits non-zero with no result line;
    copied alone into an empty directory it fails too."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout

"""The PyTorch port stands without JAX.

The card's machine has no JAX, so the port (``bulletproofs_r1cs_gadgets_tpu_torch``),
``chip_smoke.py`` and ``chip_profile.py`` must import with ``jax`` blocked,
must never import the JAX package's ``ops`` layer, and both scripts must
refuse to run (non-zero exit, no result line) where there is no GPU, and
``chip_smoke.py`` also where there is no repository around it.  Tolerance: none (exact exit codes and output).
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "bulletproofs_r1cs_gadgets_tpu_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_profile.py",
    ]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import bulletproofs_r1cs_gadgets_tpu_torch as bp\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch import prove_provers, "
        "batch_verify\n"
        "import bulletproofs_r1cs_gadgets_tpu_torch.ops.build\n"
        "import chip_smoke\n"
        "import chip_profile\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
        "assert not any(m.startswith('bulletproofs_r1cs_gadgets_tpu.ops')\n"
        "               for m in sys.modules)\n"
        "assert prove_provers.__module__.endswith('parallel.batch')\n"
        "assert batch_verify.__module__.endswith('core.verifier')\n"
        "print(bp.TorchBackend.__name__)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "TorchBackend"


@pytest.mark.parametrize(
    "pattern",
    [
        r"^\s*(import|from)\s+jax\b",
        r"bulletproofs_r1cs_gadgets_tpu\.ops\b",
        r"from\s+bulletproofs_r1cs_gadgets_tpu\s+import\s+.*\bops\b",
    ],
)
def test_port_sources_never_import_jax(pattern):
    rx = re.compile(pattern, re.M)
    offenders = [
        str(p.relative_to(ROOT)) for p in _port_sources()
        if rx.search(p.read_text())
    ]
    assert offenders == []


def _no_ok_line(stdout: str) -> bool:
    return '"ok": true' not in stdout


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode != 0
    assert _no_ok_line(out.stdout)


def test_chip_profile_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "chip_profile.py", "--out", str(tmp_path / "p.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert not (tmp_path / "p.json").exists()


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=env,
    )
    assert out.returncode != 0
    assert _no_ok_line(out.stdout)

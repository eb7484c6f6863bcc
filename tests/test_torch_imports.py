"""The PyTorch port stands without JAX and without the JAX package.

The card's machine has no JAX, so the port (``bulletproofs_r1cs_gadgets_tpu_torch``),
``chip_smoke.py`` and ``chip_profile.py`` must import with ``jax`` blocked,
must never import any module of the JAX package (the port keeps its own
copies of the host layers, ``ops/native_backend.py`` among them; every
``*.py`` of the port is scanned; comments may cite the JAX package by
path),
and both scripts, the default ``TorchBackend()`` / ``DeviceBackend()``,
the sharded backends, ``make_sharded_step`` and the dry-run entry must
refuse to run (non-zero exit, no result line, an error) where there is
no GPU, and
``chip_smoke.py`` also where there is no repository around it.  The
port's C++ host library builds safely when two processes load it at
once.  Tolerance: none (exact exit codes and output).
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
        "batch_verify, Route, TorchBackend\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.ops.native_backend import "
        "NativeBackend\n"
        "TorchBackend('cpu', route=Route())\n"
        "assert NativeBackend().threads == 1\n"
        "assert not hasattr(bp, 'NativeBackend')\n"
        "import bulletproofs_r1cs_gadgets_tpu_torch.ops.build\n"
        "import bulletproofs_r1cs_gadgets_tpu_torch.carry\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.ops.backend import "
        "DeviceBackend\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.ops.field import FP, FQ\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.ops.msm import MsmEngine\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.ops.poseidon import "
        "DevicePoseidon\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.parallel.pipeline import "
        "proving_step, make_sharded_step\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.parallel.sharded_backend "
        "import ShardedMsmBackend, BatchShardedBackend\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.ops.msm import "
        "msm_chunk_impl, scalars_to_digits\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch import graft_entry\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.gadgets import factors, "
        "mimc, not_equals, range_proof, set_membership, set_membership_1, "
        "set_non_membership\n"
        "from bulletproofs_r1cs_gadgets_tpu_torch.models import osmt\n"
        "import bulletproofs_r1cs_gadgets_tpu_torch.native.build\n"
        "import chip_smoke\n"
        "import chip_profile\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
        "jaxpkg = [m for m in sys.modules\n"
        "          if m == 'bulletproofs_r1cs_gadgets_tpu'\n"
        "          or m.startswith('bulletproofs_r1cs_gadgets_tpu.')]\n"
        "assert jaxpkg == [], jaxpkg\n"
        "assert prove_provers.__module__ == "
        "'bulletproofs_r1cs_gadgets_tpu_torch.parallel.batch'\n"
        "assert batch_verify.__module__ == "
        "'bulletproofs_r1cs_gadgets_tpu_torch.core.verifier'\n"
        "assert bp.NATIVE_LOADED\n"
        "print(bp.TorchBackend.__name__)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "TorchBackend"


# Import lines only: the copied host layers' comments cite the JAX
# package's modules by path.  The ids are the patterns' earlier names.
@pytest.mark.parametrize(
    "pattern",
    [
        r"^\s*(import|from)\s+jax\b",
        pytest.param(
            r"^\s*(import|from)\s+bulletproofs_r1cs_gadgets_tpu\.ops\b",
            id="bulletproofs_r1cs_gadgets_tpu\\.ops\\b",
        ),
        pytest.param(
            r"^\s*from\s+bulletproofs_r1cs_gadgets_tpu\s+import\s+.*\bops\b",
            id="from\\s+bulletproofs_r1cs_gadgets_tpu\\s+import\\s+.*\\bops\\b",
        ),
        pytest.param(
            r"^\s*(from|import)\s+bulletproofs_r1cs_gadgets_tpu(?!_torch)\b",
            id="any-jax-package-module",
        ),
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


def test_torch_backend_defaults_to_the_card():
    """``TorchBackend()`` runs on the card; without one it refuses rather
    than fall back to the plain versions on the host.  Only an explicit
    ``"cpu"`` gets the host."""
    from bulletproofs_r1cs_gadgets_tpu_torch import TorchBackend

    if torch.cuda.is_available():
        assert TorchBackend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchBackend()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchBackend("cuda:0")
    assert TorchBackend("cpu").device == torch.device("cpu")


def test_device_backend_defaults_to_the_card():
    """``DeviceBackend()`` runs on the card; without one it refuses rather
    than fall back to the plain versions on the host.  Only an explicit
    ``"cpu"`` gets the host."""
    from bulletproofs_r1cs_gadgets_tpu_torch.ops.backend import DeviceBackend

    if torch.cuda.is_available():
        assert DeviceBackend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceBackend()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceBackend("cuda:0")
    assert DeviceBackend("cpu").device == torch.device("cpu")


def test_sharded_entry_points_need_the_card():
    """The sharded backends, the sharded step and the dry-run entry take
    every visible card by default; without one they raise (and the
    module's command exits non-zero) rather than run on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bulletproofs_r1cs_gadgets_tpu_torch import graft_entry
    from bulletproofs_r1cs_gadgets_tpu_torch.parallel.mesh import make_mesh
    from bulletproofs_r1cs_gadgets_tpu_torch.parallel.pipeline import (
        make_sharded_step,
    )
    from bulletproofs_r1cs_gadgets_tpu_torch.parallel.sharded_backend import (
        BatchShardedBackend,
        ShardedMsmBackend,
    )

    for fn in (ShardedMsmBackend, BatchShardedBackend, make_sharded_step,
               lambda: make_sharded_step(make_mesh()),
               lambda: graft_entry.dryrun_multichip(1), graft_entry.entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedMsmBackend(["cuda:0"] * 4)
    out = subprocess.run(
        [sys.executable, "-m", "bulletproofs_r1cs_gadgets_tpu_torch.graft_entry"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "dryrun_multichip" not in out.stdout
    assert "no CUDA device" in out.stderr


def _jax_package_exports() -> tuple[list[str], str]:
    """The JAX package's ``__all__`` and ``__version__``, read from its
    ``__init__.py`` with ``ast`` (nothing of it is imported)."""
    import ast

    tree = ast.parse((ROOT / "bulletproofs_r1cs_gadgets_tpu" / "__init__.py").read_text())
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("__all__", "__version__"):
                found[name] = ast.literal_eval(node.value)
    return found["__all__"], found["__version__"]


def test_port_exports_every_top_level_name_of_the_jax_package():
    """Every name in the JAX package's ``__all__`` is an attribute of the
    port and in the port's ``__all__``, and ``__version__`` is the same."""
    import bulletproofs_r1cs_gadgets_tpu_torch as bp

    names, version = _jax_package_exports()
    assert {"Variable", "LinearCombination", "errors"} <= set(names)
    assert [n for n in names if not hasattr(bp, n)] == []
    assert [n for n in names if n not in bp.__all__] == []
    assert bp.__version__ == version
    assert bp.errors.VerificationError is bp.VerificationError
    assert bp.Variable.__module__ == \
        "bulletproofs_r1cs_gadgets_tpu_torch.core.linear_combination"


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


def test_native_loader_builds_once_for_two_processes(tmp_path):
    """Two processes load the port's C++ host library at once from an
    empty build directory: one builds it under the lock, the other waits,
    and both load a whole library."""
    code = (
        "import sys\n"
        "import bulletproofs_r1cs_gadgets_tpu_torch.native.loader as ld\n"
        "ld.BUILD_DIR = sys.argv[1]\n"
        "lib = ld.load_native()\n"
        "assert lib is not None\n"
        "out = bytearray(200)\n"
        "lib.keccak_f1600(out)\n"
        "print(ld.library_path(), out.hex()[:16])\n"
    )
    build_dir = tmp_path / "build"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(build_dir)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1  # the same library, the same keccak output
    so = lines.pop().split()[0]
    assert so.startswith(str(build_dir)) and os.path.exists(so)
    assert not list(build_dir.glob("*.tmp"))

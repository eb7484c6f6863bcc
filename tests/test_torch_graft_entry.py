"""The port's entry points (``graft_entry.py``, the counterpart of
``__graft_entry__.py``) on the CPU.

* ``entry("cpu")`` returns ``proving_step`` and the reference's inputs:
  the same witness values, points and bits as ``__graft_entry__.entry()``;
  its digests equal the host Poseidon chain and its commitment the host
  MSM;
* ``dryrun_multichip(4, devices=["cpu"] * 4)`` runs phases A, B, B2, C
  and D end to end on four CPU devices (the kernels' plain versions),
  each printing its line.

Tolerance: exact (equal field elements, points and bits).
"""

import numpy as np

import __graft_entry__ as jentry
import bulletproofs_r1cs_gadgets_tpu_torch as port
from bulletproofs_r1cs_gadgets_tpu.ops import curve as JC
from bulletproofs_r1cs_gadgets_tpu.ops.field import FQ as JFQ
from bulletproofs_r1cs_gadgets_tpu_torch import graft_entry
from bulletproofs_r1cs_gadgets_tpu_torch.gadgets.poseidon import (
    Poseidon_hash_2,
    SboxType,
)
from bulletproofs_r1cs_gadgets_tpu_torch.ops.curve import points_from_device
from bulletproofs_r1cs_gadgets_tpu_torch.ops.field import FQ
from bulletproofs_r1cs_gadgets_tpu_torch.parallel import pipeline


def test_entry_returns_the_reference_step_and_inputs():
    step, (witness, points, bits) = graft_entry.entry("cpu")
    jstep, (jw, jp, jb) = jentry.entry()
    assert step is pipeline.proving_step
    assert witness.shape == (8, 4, 8) and witness.device.type == "cpu"
    assert FQ.to_ints(witness.reshape(-1, 8)) == JFQ.to_ints(
        jw.reshape(-1, jw.shape[-1]))
    assert [p.compress() for p in points_from_device(points)] == [
        p.compress() for p in JC.points_from_device(jp)]
    assert np.array_equal(bits.numpy(), np.asarray(jb))
    digest, commitment = step(witness, points, bits)
    params = pipeline.flagship_hasher("cpu").params
    rows = FQ.to_ints(witness.reshape(-1, 8))
    exp = []
    for i in range(8):
        acc = port.Scalar(rows[4 * i])
        for v in rows[4 * i + 1 : 4 * i + 4]:
            acc = Poseidon_hash_2(acc, port.Scalar(v), params, SboxType.Cube)
        exp.append(acc.v)
    assert FQ.to_ints(digest) == exp
    ks = [int("".join(str(b) for b in row[::-1]), 2) for row in bits.tolist()]
    want = port.multiscalar_mul([port.Scalar(k) for k in ks],
                                points_from_device(points))
    assert points_from_device(commitment)[0] == want


def test_dryrun_multichip_on_cpu_devices(capsys):
    graft_entry.dryrun_multichip(4, devices=["cpu"] * 4)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip")]
    assert [ln.split()[1] for ln in lines] == ["A", "B", "B2", "C", "D"]
    assert all(" OK: " in ln for ln in lines)

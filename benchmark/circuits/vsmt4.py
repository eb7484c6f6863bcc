"""VSMT-4 on the port: the 4-ary sparse Merkle tree, the compiled
circuit (``CompiledVSMT4``) and a prover synthesized for one leaf."""


def tree(bp, params, config):
    from bulletproofs_r1cs_gadgets_tpu_torch.models.vsmt4 import (
        VanillaSparseMerkleTree4)

    return VanillaSparseMerkleTree4(params, depth=config["depth"])


def compile(bp, params, config):
    from bulletproofs_r1cs_gadgets_tpu_torch.models import compiled

    return compiled.CompiledVSMT4(params, config["depth"])


def synthesize(bp, comp, prover, key, leaf, path, blind):
    """The leaf's commitments on `prover` and the circuit's wires."""
    nodes = [x for level in path for x in level]
    k = bp.Scalar(key)
    comms = comp.commit_prover(prover, leaf, k, nodes, rng=blind)
    return comms, comp.witness(leaf, k, nodes)

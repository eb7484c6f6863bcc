"""VSMT-2 on the port: the binary sparse Merkle tree, the compiled
circuit (``CompiledVSMT2``) and a prover synthesized for one leaf."""


def tree(bp, params, config):
    return bp.VanillaSparseMerkleTree(params, depth=config["depth"])


def compile(bp, params, config):
    from bulletproofs_r1cs_gadgets_tpu_torch.models import compiled

    return compiled.CompiledVSMT2(
        params, config["depth"],
        constrain_index_bits=config["constrain_index_bits"])


def synthesize(bp, comp, prover, key, leaf, path, blind):
    """The leaf's commitments on `prover` and the circuit's wires."""
    bits = [(key >> i) & 1 for i in range(comp.depth)]
    nodes = list(reversed(path))
    comms = comp.commit_prover(prover, leaf, bits, nodes, rng=blind)
    return comms, comp.witness(leaf, bits, nodes)

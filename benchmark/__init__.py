"""The benchmark of bulletproofs_r1cs_gadgets_tpu_torch: ``BENCHMARK.json``
names the cells; ``python3 -m benchmark.run`` runs one of them once."""

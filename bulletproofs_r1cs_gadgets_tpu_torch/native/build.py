"""python -m bulletproofs_r1cs_gadgets_tpu_torch.native.build"""
from .loader import build

if __name__ == "__main__":
    print(build(force=True))

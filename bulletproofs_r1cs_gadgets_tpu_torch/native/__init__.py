"""Native (C++) host-side acceleration. Falls back to pure Python when the
shared library has not been built (build with: python -m
bulletproofs_r1cs_gadgets_tpu_torch.native.build)."""

try:
    from .loader import load_native as _load_native
    _native = _load_native()
except Exception:  # pragma: no cover - optional acceleration
    _native = None

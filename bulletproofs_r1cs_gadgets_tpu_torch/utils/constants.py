"""Numeric constants for the curve25519 / ristretto255 algebra.

The reference stack (lovesh/bulletproofs-r1cs-gadgets -> curve25519-dalek) works
over two primes:

* ``L``  -- the Ristretto group order, the *scalar field* every R1CS value lives
  in (reference: ``curve25519_dalek::scalar::Scalar``, used throughout e.g.
  ``reference/src/r1cs_utils.rs:2``).
* ``P``  -- the curve's base field 2^255 - 19 (used inside
  ``RistrettoPoint`` arithmetic, reference dep ``curve25519-dalek``).

All derived Edwards/Ristretto constants below are *computed* (not transcribed)
from first principles at import time; see the assertions at the bottom.
"""

# Base field of curve25519.
P = 2**255 - 19

# Prime order of the Ristretto group == order of the R1CS scalar field.
# l = 2^252 + 27742317777372353535851937790883648493
L_LOW = 27742317777372353535851937790883648493
L = 2**252 + L_LOW

# Edwards curve: -x^2 + y^2 = 1 + d x^2 y^2  (a = -1)
# d = -121665/121666 mod P
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P

# sqrt(-1) mod P, the element i with i^2 = -1 and i "non-negative"
# (curve25519-dalek convention: negative == odd canonical encoding).


def _is_negative(x: int) -> bool:
    """dalek's IS_NEGATIVE: LSB of the canonical little-endian encoding."""
    return (x % P) & 1 == 1


def _abs_fe(x: int) -> int:
    x %= P
    return P - x if _is_negative(x) else x


def _sqrt(x: int) -> int:
    """Square root mod P (P % 8 == 5), non-negative branch; raises if no root."""
    x %= P
    r = pow(x, (P + 3) // 8, P)
    if (r * r) % P != x:
        r = (r * pow(2, (P - 1) // 4, P)) % P  # multiply by sqrt(-1)
    if (r * r) % P != x:
        raise ValueError("not a square")
    return _abs_fe(r)


SQRT_M1 = _sqrt(P - 1)

# Constants used by ristretto255 encode/decode/Elligator (RFC 9496 notation),
# all derived: INVSQRT_A_MINUS_D = 1/sqrt(a-d) with a = -1.
INVSQRT_A_MINUS_D = _abs_fe(pow(_sqrt((-1 - D) % P), P - 2, P))
ONE_MINUS_D_SQ = (1 - D * D) % P  # 1 - d^2
D_MINUS_ONE_SQ = ((D - 1) * (D - 1)) % P  # (d - 1)^2
# sqrt(a*d - 1), a = -1.  curve25519-dalek's SQRT_AD_MINUS_ONE constant is
# the NEGATIVE (odd-encoding) root -- verified against libsodium's
# crypto_core_ristretto255_from_hash (tests/golden/test_golden_ristretto.py);
# with the even root every Elligator output is the negation of dalek's and
# all derived generators diverge.
SQRT_AD_MINUS_ONE = P - _sqrt((-(D + 1)) % P)

# Ed25519 basepoint: y = 4/5, x recovered with even (non-negative) sign.
ED25519_BASEPOINT_Y = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int) -> int:
    # x^2 = (y^2 - 1) / (d y^2 + 1)
    yy = (y * y) % P
    xx = ((yy - 1) * pow(D * yy + 1, P - 2, P)) % P
    return _sqrt(xx)


ED25519_BASEPOINT_X = _recover_x(ED25519_BASEPOINT_Y)

# sanity: basepoint is on the curve
assert (
    (-ED25519_BASEPOINT_X**2 + ED25519_BASEPOINT_Y**2) % P
    == (1 + D * ED25519_BASEPOINT_X**2 * ED25519_BASEPOINT_Y**2) % P
)
assert (SQRT_M1 * SQRT_M1) % P == P - 1

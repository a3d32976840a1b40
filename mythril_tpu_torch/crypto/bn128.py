"""alt_bn128 curve + optimal-ate pairing for precompiles 6/7/8.

Behavioral model: the py_ecc `optimized_bn128` module the reference
imports in mythril/laser/ethereum/natives.py:6-8. Standard textbook
construction: F_p, the quadratic extension F_p2 = F_p[i]/(i^2+1), the
12th-degree extension F_p12 = F_p[w]/(w^12 - 18 w^6 + 82), short
Weierstrass arithmetic, and the ate-pairing Miller loop with final
exponentiation. Affine (not Jacobian) coordinates: precompiles only run
on concrete inputs, so clarity beats constant-factor speed here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

field_modulus = (
    21888242871839275222246405745257275088696311157297823662689037894645226208583
)
curve_order = (
    21888242871839275222246405745257275088548364400416034343698204186575808495617
)

ate_loop_count = 29793968203157093288
log_ate_loop_count = 63


# --- extension-field tower -------------------------------------------------

class FQ:
    """An element of F_p."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % field_modulus

    def __add__(self, other):
        return FQ(self.n + _n(other))

    __radd__ = __add__

    def __sub__(self, other):
        return FQ(self.n - _n(other))

    def __rsub__(self, other):
        return FQ(_n(other) - self.n)

    def __mul__(self, other):
        return FQ(self.n * _n(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return FQ(self.n * pow(_n(other), -1, field_modulus))

    def __rtruediv__(self, other):
        return FQ(_n(other) * pow(self.n, -1, field_modulus))

    def __pow__(self, e: int):
        return FQ(pow(self.n, e, field_modulus))

    def __neg__(self):
        return FQ(-self.n)

    def __eq__(self, other):
        return self.n == _n(other)

    def __ne__(self, other):
        return not self == other

    def __repr__(self):
        return f"FQ({self.n})"

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def zero(cls):
        return cls(0)


def _n(x) -> int:
    return x.n if isinstance(x, FQ) else int(x)


def _poly_rounded_div(a: List[int], b: List[int]) -> List[int]:
    dega = _deg(a)
    degb = _deg(b)
    temp = list(a)
    out = [0] * len(a)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * pow(b[degb], -1, field_modulus)) % field_modulus
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[0]) % field_modulus
    return out[: _deg(out) + 1]


def _deg(p: List[int]) -> int:
    d = len(p) - 1
    while p[d] == 0 and d:
        d -= 1
    return d


class FQP:
    """An element of a polynomial extension of F_p (template for FQ2 /
    FQ12; subclasses pin `degree` and `modulus_coeffs`)."""

    degree: int = 0
    modulus_coeffs: Tuple[int, ...] = ()

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = [c % field_modulus for c in coeffs]

    def __add__(self, other):
        return type(self)([(a + b) % field_modulus for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([(a - b) % field_modulus for a, b in zip(self.coeffs, other.coeffs)])

    def __mul__(self, other):
        if isinstance(other, (int, FQ)):
            k = _n(other)
            return type(self)([(c * k) % field_modulus for c in self.coeffs])
        b = [0] * (self.degree * 2 - 1)
        for i, ca in enumerate(self.coeffs):
            for j, cb in enumerate(other.coeffs):
                b[i + j] = (b[i + j] + ca * cb) % field_modulus
        # reduce by the defining polynomial
        while len(b) > self.degree:
            exp, top = len(b) - self.degree - 1, b.pop()
            for i, mc in enumerate(self.modulus_coeffs):
                b[exp + i] = (b[exp + i] - top * mc) % field_modulus
        return type(self)(b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, (int, FQ)):
            k = pow(_n(other), -1, field_modulus)
            return type(self)([(c * k) % field_modulus for c in self.coeffs])
        return self * other.inv()

    def __pow__(self, e: int):
        result = type(self).one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Inverse by the extended Euclidean algorithm over polynomials."""
        lm, hm = [1] + [0] * self.degree, [0] * (self.degree + 1)
        low = self.coeffs + [0]
        high = list(self.modulus_coeffs) + [1]
        while _deg(low):
            r = _poly_rounded_div(high, low)
            r += [0] * (self.degree + 1 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(self.degree + 1):
                for j in range(self.degree + 1 - i):
                    nm[i + j] = (nm[i + j] - lm[i] * r[j]) % field_modulus
                    new[i + j] = (new[i + j] - low[i] * r[j]) % field_modulus
            lm, low, hm, high = nm, new, lm, low
        k = pow(low[0], -1, field_modulus)
        return type(self)([(c * k) % field_modulus for c in lm[: self.degree]])

    def __neg__(self):
        return type(self)([-c % field_modulus for c in self.coeffs])

    def __eq__(self, other):
        return isinstance(other, type(self)) and self.coeffs == other.coeffs

    def __ne__(self, other):
        return not self == other

    def __repr__(self):
        return f"{type(self).__name__}({self.coeffs})"

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)


class FQ2(FQP):
    degree = 2
    modulus_coeffs = (1, 0)  # i^2 = -1


class FQ12(FQP):
    degree = 12
    modulus_coeffs = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # w^12 = 18 w^6 - 82


# --- curve arithmetic ------------------------------------------------------

b = FQ(3)
b2 = FQ2([3, 0]) / FQ2([9, 1])
b12 = FQ12([3] + [0] * 11)

G1 = (FQ(1), FQ(2))
G2 = (
    FQ2(
        [
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ]
    ),
    FQ2(
        [
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ]
    ),
)

Point = Optional[Tuple[object, object]]  # None is the identity


def is_on_curve(pt: Point, b_coeff) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == b_coeff


def double(pt: Point) -> Point:
    if pt is None:
        return None
    x, y = pt
    if y == y - y:  # y == 0
        return None
    m = 3 * x * x / (2 * y)
    newx = m * m - 2 * x
    newy = -m * newx + m * x - y
    return (newx, newy)


def add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return double(p1)
    if x1 == x2:
        return None
    m = (y2 - y1) / (x2 - x1)
    newx = m * m - x1 - x2
    newy = -m * newx + m * x1 - y1
    return (newx, newy)


def multiply(pt: Point, n: int) -> Point:
    if pt is None or n % curve_order == 0:
        return None
    n = n % curve_order
    result: Point = None
    addend = pt
    while n:
        if n & 1:
            result = add(result, addend)
        addend = double(addend)
        n >>= 1
    return result


def neg(pt: Point) -> Point:
    if pt is None:
        return None
    x, y = pt
    return (x, -y)


# --- pairing ---------------------------------------------------------------

w = FQ12([0, 1] + [0] * 10)


def twist(pt: Point) -> Point:
    """Untwist a G2 point (over FQ2) into the full FQ12 curve."""
    if pt is None:
        return None
    x, y = pt
    # change of basis 1, i  ->  1, w^6 - 9 for the sextic twist
    xc = [x.coeffs[0] - 9 * x.coeffs[1], x.coeffs[1]]
    yc = [y.coeffs[0] - 9 * y.coeffs[1], y.coeffs[1]]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx * w**2, ny * w**3)


def cast_point_to_fq12(pt: Point) -> Point:
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x.n] + [0] * 11), FQ12([y.n] + [0] * 11))


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = 3 * x1 * x1 / (2 * y1)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(Q: Point, P: Point) -> FQ12:
    if Q is None or P is None:
        return FQ12.one()
    R = Q
    f = FQ12.one()
    for i in range(log_ate_loop_count, -1, -1):
        f = f * f * _linefunc(R, R, P)
        R = double(R)
        if ate_loop_count & (2**i):
            f = f * _linefunc(R, Q, P)
            R = add(R, Q)
    Q1 = (Q[0] ** field_modulus, Q[1] ** field_modulus)
    nQ2 = (Q1[0] ** field_modulus, -Q1[1])
    f = f * _linefunc(R, Q1, P)
    R = add(R, Q1)
    f = f * _linefunc(R, nQ2, P)
    return f ** ((field_modulus**12 - 1) // curve_order)


def pairing(Q: Point, P: Point) -> FQ12:
    """e(P, Q) with P in G1 (FQ coords) and Q in G2 (FQ2 coords)."""
    assert is_on_curve(P, b)
    assert is_on_curve(Q, b2)
    return miller_loop(twist(Q), cast_point_to_fq12(P))

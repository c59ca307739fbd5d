"""Operation counts and the published peak of one H100, for kernel roofline
shares.

The counts are the least int32 operations per item of each kernel, as (IMAD,
ALU), in radix 2^8 with the carry schedule of ``crypto/field.py``: a
column's products accumulate in multiply-adds and the fold lo + 38 hi is one
more per column; a carry pass masks and shifts all 32 limbs and adds the
carries into limbs 1-31, and 38 * carry + limb 0 is a multiply-add. The
products alone are over half of all operations, so the IMAD pipe bounds
each kernel. (Copied from ``chip_smoke.py``'s timing phase, which divides by
the SM clock it reads; here the divisor is the published clock.)

The peak: 64 IMAD results per clock per SM (sm_90), 132 SMs, 1,980 MHz
boost (NVIDIA H100 SXM5 data sheet).
"""

from __future__ import annotations

IMAD_PER_CLK_PER_SM = 64
SMS = 132
CLOCK_HZ = 1.98e9
IMAD_PER_S = IMAD_PER_CLK_PER_SM * SMS * CLOCK_HZ


def _ops(imad: int, alu: int) -> tuple:
    return (imad, alu)


def _lin(*terms) -> tuple:
    """Sum of (count, (imad, alu)) terms."""
    return (sum(k * t[0] for k, t in terms), sum(k * t[1] for k, t in terms))


CARRY_PASS = _ops(1, 32 * 2 + 31)
MUL_OPS = _lin((1, _ops(1024 + 32, 0)), (4, CARRY_PASS))
SQR_OPS = _lin((1, _ops(528 + 32, 32)), (4, CARRY_PASS))  # 496 cross + 32 diagonal; 32 doublings
ADD_OPS = _lin((1, _ops(0, 32)), (2, CARRY_PASS))  # add/sub/neg, and mul_small<2> as an add
PDBL_OPS = _lin((4, SQR_OPS), (4, MUL_OPS), (8, ADD_OPS))  # ed25519.point_double
PADD_OPS = _lin((9, MUL_OPS), (9, ADD_OPS))  # ed25519.point_add
LADDER_STEP = _lin((2, PDBL_OPS), (1, PADD_OPS))
OPS_PER_ITEM = {
    "inv": _lin((254, SQR_OPS), (11, MUL_OPS)),
    "p58": _lin((251, SQR_OPS), (11, MUL_OPS)),
    # table: 1 doubling + 13 additions; then 128 steps of 2 doublings + 1 addition
    "ladder": _lin((1, PDBL_OPS), (13, PADD_OPS), (128, LADDER_STEP)),
}

# csrc/ladder.cu: LADDER_THREADS (128) threads a block, FE_K (8) lanes an
# item, so a block holds 16 rows; the launch's grid is rows / 16 blocks.
LADDER_ROWS_PER_BLOCK = 16


def bound_s(kernel: str, rows: int) -> float:
    """The least time of one launch over ``rows`` padded rows: its IMAD
    operations over the IMAD pipe's published peak."""
    return OPS_PER_ITEM[kernel][0] * rows / IMAD_PER_S

"""The least time the card needs for a band rung's work.

A rung runs a band of ``band_words`` 32-bit words down every column of each
of its pairs, one Myers word step per word and column, whatever kernel
implements it.  One word step takes at least 14 int32 instructions on
sm_90 (the figure of every bound the program's smoke script prints,
``chip_smoke.py:346-355``, and what ``ops/sass_count.py`` counts in K11's
compiled loop).  The card issues int32 instructions on 64 lanes of each SM
per clock, and moves 3.35 TB/s of device memory (H100 SXM data sheet).  The
least time is the larger of the instructions over that rate and the bytes
(each input read once, each output written once) over the memory rate.
"""

from __future__ import annotations

OPS_PER_WORD_STEP = 14
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12


def word_steps(band_words: int, columns: int) -> int:
    """Word steps of a band of ``band_words`` over ``columns`` columns in all."""
    return band_words * columns


def int32_rate(sms: int, sm_clock_hz: float) -> float:
    """int32 instructions a second over the card's SMs at their clock."""
    return sms * INT32_LANES_PER_SM * sm_clock_hz


def least_seconds(band_words: int, columns: int, in_bytes: int, out_bytes: int,
                  sms: int, sm_clock_hz: float) -> float:
    """The least time for one rung: the larger of its operations over the
    int32 rate and its bytes over the memory rate."""
    ops_s = word_steps(band_words, columns) * OPS_PER_WORD_STEP / int32_rate(sms, sm_clock_hz)
    return max(ops_s, (in_bytes + out_bytes) / HBM_BYTES_PER_S)

"""The FLOP and byte counts of the yardstick against the bounds in
``PERF.md``'s kernel table (``bound_ms``)."""
import json

import pytest

from bench_port.yardstick import counts
from bench_port.yardstick.peaks import least_seconds

MODEL = json.load(open("bench_port/configs/cp_emgnet_f32.json"))["model"]


@pytest.mark.parametrize("rows,sessions,dtype,ms,by", [
    (32768, 32768, "float32", 1.0223, "operations"),
    (819200, 32768, "float32", 25.559, "operations"),
    (32768, 32768, "bfloat16", 0.40427, "bytes"),
])
def test_encoder_chain_bound(rows, sessions, dtype, ms, by):
    t, got_by = counts.encoder_chain_bound_s(MODEL, rows, sessions, dtype)
    assert got_by == by
    assert t * 1e3 == pytest.approx(ms, rel=2e-4)


@pytest.mark.parametrize("backward,ms", [(False, 0.15633), (True, 0.31267)])
def test_k5_bound_at_c150(backward, ms):
    t, by = least_seconds(*counts.k5_cost(150, 328, 512, 512, backward,
                                          "float32"), "float32")
    assert by == "operations"
    assert t * 1e3 == pytest.approx(ms, rel=1e-4)


def test_model_counts():
    assert counts.folded_chain_macs_per_row(MODEL) == 2573968
    # convs on 12 positions, 34 taps that meet data; 768x512, 6 x 512x512,
    # the head 512x16 and the scores 16x41
    assert counts.model_macs_per_row(MODEL) == (
        34 * 64 + 34 * 64 * 64 + 768 * 512 + 6 * 512 * 512 + 512 * 16
        + 16 * 41)

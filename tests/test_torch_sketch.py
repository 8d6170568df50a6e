"""The port's count-min sketch against the reference's.

The bucket and bloom tables (lowbias32 on salted ids, numpy uint32 in both
packages) must be equal for every id and width, non-powers of two included;
the torch row operations on a batch of samples must equal the reference's
numpy operations sample by sample. Everything is an integer: exact.
"""
import numpy as np
import pytest
import torch

from repro.core import jax_cache
from repro.core import sketch as ref_sketch
from repro_torch.core import sketch, torch_cache

WIDTHS = [1, 2, 7, 33, 64, 96, 100, 256, 1_000, 8_000, 100_000, 2**31 - 1]


def test_salts_and_depths_match():
    assert (sketch.DEPTH, sketch.BLOOM_DEPTH) == (ref_sketch.DEPTH, ref_sketch.BLOOM_DEPTH)
    assert sketch._SALTS == ref_sketch._SALTS
    assert sketch._BLOOM_SALTS == ref_sketch._BLOOM_SALTS


@pytest.mark.parametrize("width", WIDTHS)
def test_bucket_and_bloom_tables_match(width):
    ids = np.arange(100_001)
    port, ref = sketch.bucket_table(ids, width), ref_sketch.bucket_table(ids, width)
    assert port.dtype == ref.dtype == np.int32 and port.shape == (ids.size, sketch.DEPTH)
    np.testing.assert_array_equal(port, ref)
    port, ref = sketch.bloom_table(ids, width), ref_sketch.bloom_table(ids, width)
    assert port.dtype == ref.dtype == np.int32 and port.shape == (ids.size, sketch.BLOOM_DEPTH)
    np.testing.assert_array_equal(port, ref)


def test_tables_at_the_top_of_the_id_range():
    """ids near 2**32 - 1: (id + 1) wraps to 0 in uint32, in both packages."""
    ids = np.array([2**31 - 1, 2**32 - 2, 2**32 - 1], np.uint32)
    for width in (97, 100_000):
        np.testing.assert_array_equal(sketch.bucket_table(ids, width), ref_sketch.bucket_table(ids, width))
        np.testing.assert_array_equal(sketch.bloom_table(ids, width), ref_sketch.bloom_table(ids, width))


@pytest.mark.parametrize("kind,kw", [("tinylfu", dict(doorkeeper=96)), ("plfua_dyn", dict(sketch_width=130))])
def test_spec_tables_match(kind, kw):
    port = torch_cache.PolicySpec(kind=kind, n_objects=500, capacity=20, **kw)
    ref = jax_cache.PolicySpec(kind=kind, n_objects=500, capacity=20, **kw)
    np.testing.assert_array_equal(port._bucket_table(), ref._bucket_table())
    if port.doorkeeper:
        np.testing.assert_array_equal(port._bloom_table(), ref._bloom_table())


def _batch(seed, s=5, width=37, m_bits=29):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 50, size=(s, sketch.DEPTH, width)).astype(np.int32)
    bits = rng.random((s, m_bits)) < 0.5
    ids = rng.integers(0, 1000, size=s)
    return rows, bits, ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_operations_match(seed):
    rows, bits, ids = _batch(seed)
    width, m_bits = rows.shape[-1], bits.shape[-1]
    idx = ref_sketch.bucket_table(ids, width)
    bidx = ref_sketch.bloom_table(ids, m_bits)
    inc = np.array([True, False, True, True, False])

    t_rows = torch.as_tensor(rows.copy())
    sketch.rows_add(t_rows, torch.as_tensor(idx).long(), torch.as_tensor(inc))
    t_est = sketch.rows_estimate(t_rows, torch.as_tensor(idx).long())
    table = torch.as_tensor(ref_sketch.bucket_table(np.arange(1000), width)).long()
    t_all = sketch.rows_estimate_all(t_rows, table)
    t_bits = torch.as_tensor(bits.copy())
    t_before = sketch.bloom_contains(t_bits, torch.as_tensor(bidx).long())
    sketch.bloom_set(t_bits, torch.as_tensor(bidx).long())
    for i in range(len(ids)):
        want = ref_sketch.rows_add(rows[i], idx[i]) if inc[i] else rows[i]
        np.testing.assert_array_equal(t_rows[i].numpy(), want)
        assert int(t_est[i]) == int(ref_sketch.rows_estimate(want, idx[i]))
        np.testing.assert_array_equal(t_all[i].numpy(), ref_sketch.rows_estimate_all(want, table.numpy()))
        assert bool(t_before[i]) == bool(ref_sketch.bloom_contains(bits[i], bidx[i]))
        np.testing.assert_array_equal(t_bits[i].numpy(), ref_sketch.bloom_set(bits[i], bidx[i]))
    halved = t_rows.clone()
    sketch.rows_halve(halved)
    np.testing.assert_array_equal(halved.numpy(), ref_sketch.rows_halve(t_rows.numpy()))

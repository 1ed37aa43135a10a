"""The sampler kernel's weight layout, on the CPU: the compaction of GRU-A's
kept [16 x 128] tiles and their cut into the shares of the N thread blocks
of a cluster (dss_tpu_torch/ops/sampler.py).  The kernel itself runs only
on the card; what it reads is built here in numpy and held against the
dense masked matrix.
"""

import os

import numpy as np
import pytest
import torch

import dss_tpu.ops.pallas.sampler as jsamp
from dss_tpu_torch.convert import vocoder_params
from dss_tpu_torch.ops import sampler as tsamp

torch.set_num_threads(1)
WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights")
SHIPPED = ("vocoder_speech.npz", "vocoder_speech_b2.npz",
           "vocoder_speech_b4.npz", "vocoder_speech_b8.npz",
           "vocoder_synthetic.npz", "vocoder_synthetic_b2.npz",
           "vocoder_synthetic_b4.npz")


def _shipped(name):
    with np.load(os.path.join(WEIGHTS, name)) as f:
        return f["gru_a_wh"].astype(np.float32), f["gru_a_mask"]


def _case(case):
    """(masked recurrent matrix, mask or None) of a named case."""
    rng = np.random.default_rng(3)
    if case == "shipped":
        wh, mask = _shipped("vocoder_speech_b8.npz")
        return wh * mask, mask
    if case == "unmasked":
        return _shipped("vocoder_speech.npz")[0], None
    if case == "nothing_pruned":
        wh = _shipped("vocoder_synthetic.npz")[0]
        return wh, np.ones_like(wh)
    H = {"narrow_20": 20, "narrow_72": 72, "narrow_16": 16}[case]
    return (rng.normal(size=(H, 3 * H)) * 0.2).astype(np.float32), None


@pytest.mark.parametrize("name", SHIPPED)
def test_compacted_tiles_scatter_back_to_the_masked_matrix(name):
    """Scattering the compacted tiles back by their (row block, column
    group) indices reproduces gru_a_wh * gru_a_mask exactly, and the kept
    count is tile_sparse_pattern's."""
    wh, mask = _shipped(name)
    tiles, index = tsamp.compact_gru_a_tiles(wh * mask, mask)
    pattern, kept = tsamp.tile_sparse_pattern(mask)
    assert pattern is not None and kept < 0.25
    assert len(tiles) == sum(len(rows) for rows in pattern)
    assert tiles.shape[1:] == (tsamp.ROW_BLOCK, tsamp.COL_BLOCK)
    assert index.dtype == np.int32 and tiles.dtype == np.float32
    got = tsamp.scatter_gru_a_tiles(tiles, index, wh.shape[0])
    np.testing.assert_array_equal(got, wh * mask)
    # The prepared weight set carries the masked matrix, and its nonzeros
    # name the same tiles as the mask: what the kernel's layout is cut from.
    with np.load(os.path.join(WEIGHTS, name)) as f:
        tp = vocoder_params({k: f[k] for k in f.files})
    S = tsamp.bunch_of(tp)
    w = tsamp.prepare_sampler_weights(tp) if S == 1 else \
        tsamp.prepare_bunched_sampler_weights(tp)
    dense = w["wh_a"].numpy()
    np.testing.assert_array_equal(dense, wh * mask)
    tiles_w, index_w = tsamp.compact_gru_a_tiles(dense, dense != 0)
    np.testing.assert_array_equal(tiles_w, tiles)
    np.testing.assert_array_equal(index_w, index)


@pytest.mark.parametrize("name", SHIPPED)
def test_tile_sparse_pattern_agrees_with_the_jax_package(name):
    """The port's tile_sparse_pattern and the JAX package's give the same
    pattern and kept fraction on every shipped mask."""
    _, mask = _shipped(name)
    assert tsamp.tile_sparse_pattern(mask) == jsamp.tile_sparse_pattern(mask)
    assert (tsamp.ROW_BLOCK, tsamp.COL_BLOCK) == \
        (jsamp.ROW_BLOCK, jsamp.COL_BLOCK)


@pytest.mark.parametrize("case", ["unmasked", "nothing_pruned", "narrow_20",
                                  "narrow_72"])
def test_every_tile_is_kept_without_a_tile_pattern(case):
    """No mask, a mask that prunes nothing, or widths that 16 and 128 do
    not divide: every (possibly ragged) tile is kept, zero-padded, and
    scatters back exactly."""
    wh, mask = _case(case)
    tiles, index = tsamp.compact_gru_a_tiles(wh, mask)
    H = wh.shape[0]
    assert len(tiles) == -(-H // 16) * -(-3 * H // 128)
    np.testing.assert_array_equal(
        tsamp.scatter_gru_a_tiles(tiles, index, H), wh)


@pytest.mark.parametrize("N", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["shipped", "unmasked", "narrow_20",
                                  "narrow_72", "narrow_16"])
def test_product_in_the_per_block_layout_matches_the_dense_one(case, N):
    """h @ (wh * mask) computed from the per-block work items, slot by
    slot as the kernel adds them, equals the dense product to 1e-6 (f32
    sums of at most 384 terms below 1 in another order)."""
    wh, mask = _case(case)
    H = wh.shape[0]
    tiles, index = tsamp.compact_gru_a_tiles(wh, mask)
    lay = tsamp.gru_a_cluster_layout(tiles, index, H, 96, N)
    h = np.random.default_rng(N).uniform(-1, 1, H).astype(np.float32)
    want = (h.astype(np.float64) @ wh.astype(np.float64))
    got = tsamp.gru_a_layout_product(lay, h)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("N", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["shipped", "unmasked", "narrow_20",
                                  "narrow_16"])
def test_partition_covers_every_kept_weight_and_unit_once(case, N):
    """The N unit ranges tile [0, H) in multiples of 4; the work items of
    all blocks together cover every element of every kept tile exactly
    once and nothing else; every column's slots are numbered 0 .. cnt - 1;
    the arrays have the shapes and types the kernel takes."""
    wh, mask = _case(case)
    H = wh.shape[0]
    tiles, index = tsamp.compact_gru_a_tiles(wh, mask)
    lay = tsamp.gru_a_cluster_layout(tiles, index, H, 96, N)
    u0, nuM = lay["u0"], lay["nuM"]
    assert u0[0] == 0 and u0[-1] == H and len(u0) == N + 1
    assert np.all(np.diff(u0) >= 0) and np.all(u0 % 4 == 0)
    assert nuM % 4 == 0 and nuM >= np.diff(u0).max()
    assert lay["work"].shape[1] % 32 == 0
    assert lay["tiles"].shape == (N, lay["work"].shape[1] // 32, 4, 32, 4)
    assert lay["tiles"].dtype == np.float32
    assert all(lay[k].dtype == np.int32
               for k in ("u0", "nwork", "work", "cnt"))
    covered = np.zeros((-(-H // 16) * 16, 3 * H), np.int32)
    rebuilt = np.zeros(covered.shape, np.float32)
    for r in range(N):
        ua, nu = int(u0[r]), int(u0[r + 1] - u0[r])
        items = lay["tiles"][r].transpose(0, 2, 1, 3).reshape(-1, 16)
        slots = {}
        for e in range(int(lay["nwork"][r])):
            row0, dst = lay["work"][r, e]
            slot, lc = divmod(int(dst), 3 * nuM)
            q, ul = divmod(lc, nuM)
            assert ul < nu and row0 % 16 == 0
            col = q * H + ua + ul
            covered[row0:row0 + 16, col] += 1
            rebuilt[row0:row0 + 16, col] = items[e]
            slots.setdefault(lc, []).append(slot)
        for lc, got in slots.items():
            assert sorted(got) == list(range(lay["cnt"][r, lc]))
        assert lay["cnt"][r].sum() == lay["nwork"][r]
    kept = np.zeros(covered.shape, np.int32)
    for i, j in index:
        kept[16 * i:16 * i + 16, 128 * j:128 * j + 128] = 1
    np.testing.assert_array_equal(covered, kept)
    np.testing.assert_array_equal(rebuilt[:H], wh)
    assert not rebuilt[H:].any()


@pytest.mark.parametrize("N", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 8])
def test_heads_are_cut_by_level(S, N):
    """build_cluster_layout gathers block r's S * 256 / N levels: a level's two
    half-head columns side by side, gains and inner biases in the same
    order, outer biases by level; all blocks together hold every column
    once."""
    name = "vocoder_speech.npz" if S == 1 else f"vocoder_speech_b{S}.npz"
    with np.load(os.path.join(WEIGHTS, name)) as f:
        tp = vocoder_params({k: f[k] for k in f.files})
    w = tsamp.prepare_sampler_weights(tp) if S == 1 else \
        tsamp.prepare_bunched_sampler_weights(tp)
    lay = tsamp.build_cluster_layout(w, N)
    nl = S * 256 // N
    assert tuple(lay["w_out"].shape) == (N, 32, 2 * nl)
    assert tuple(lay["b_out"].shape) == (N, nl)
    seen = []
    for r in range(N):
        for x in range(nl):
            g = r * nl + x
            c1 = (g // 256) * 512 + g % 256
            seen += [c1, c1 + 256]
            for half, c in enumerate((c1, c1 + 256)):
                assert torch.equal(lay["w_out"][r, :, 2 * x + half],
                                   w["w_out"][:, c])
                assert lay["g_out"][r, 2 * x + half] == w["g_out"][c]
                assert lay["ib_out"][r, 2 * x + half] == w["ib_out"][c]
            assert lay["b_out"][r, x] == w["b_out"][g]
    assert sorted(seen) == list(range(S * 512))


def _narrow_params(ga):
    """A seeded bunch-1 checkpoint dict at GRU-A width ``ga``."""
    rng = np.random.default_rng(ga)
    L, E, gb, cd = 256, 4, 8, 6

    def n(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.2)
                                .astype(np.float32))

    p = {"emb_sig": n(L, E), "emb_pred": n(L, E), "emb_exc": n(L, E),
         "gru_a_wx": n(3 * E + cd, 3 * ga), "gru_a_bx": n(3 * ga),
         "gru_a_wh": n(ga, 3 * ga), "gru_a_bh": n(3 * ga),
         "gru_b_wx": n(ga + cd, 3 * gb), "gru_b_bx": n(3 * gb),
         "gru_b_wh": n(gb, 3 * gb), "gru_b_bh": n(3 * gb),
         "fc_out_b": n(L)}
    for h in (1, 2):
        p[f"fc_out{h}_w"], p[f"fc_out{h}_g"] = n(gb, L), 1.0 + n(L)
    return p, gb, cd


@pytest.mark.parametrize("ga", [20, 18])
def test_layout_is_built_at_the_first_launch_only(ga):
    """Preparing weights builds no kernel layout: the plain version, which
    CPU tensors take, runs at any GRU-A width, also one that is no multiple
    of 4.  The layout is built when asked for, once, at the kernel's cluster
    size; a width the kernel cannot take is refused there by name."""
    p, gb, cd = _narrow_params(ga)
    w = tsamp.prepare_sampler_weights(p)
    assert "cluster_layout" not in w
    carry = (torch.zeros(1, ga), torch.zeros(1, gb), torch.zeros(1, 16),
             torch.zeros(1, dtype=torch.long))
    cond, lpc = torch.ones(1, 1, cd) * 0.1, torch.zeros(1, 1, 16)
    _, sig = tsamp.sampler_frames(w, carry, cond, lpc, -torch.ones(1, 1),
                                  None, 8)
    assert sig.shape == (1, 8) and bool(torch.isfinite(sig).all())
    assert "cluster_layout" not in w
    if ga % 4:
        with pytest.raises(ValueError, match="multiple of 4"):
            tsamp.cluster_layout(w)
    else:
        lay = tsamp.cluster_layout(w)
        assert tsamp.cluster_layout(w) is lay
        assert len(lay["u0"]) == tsamp.CLUSTER + 1

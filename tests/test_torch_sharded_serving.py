"""The port's multi-stream word unit with distinct per-slot streams, on the
CPU: the counterpart of tests/test_sharded_serving.py (its three tests, at
world 1), plus the unit on two gloo ranks (tests/torch_dist.py) against
world 1.  Slots carry different segments with their own lengths, every
slot's audio ships, each stream's vocoder state is its own, and chunked
emission concatenates to exactly the single-shot path's audio."""

import asyncio

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dss_tpu.vocoder.net import LPCNetModel as JLPCNet
from dss_tpu_torch.runtime.messages import ClosedLoopMessage

import torch_dist
from torch_dist import SlotFeeder, serve_segments, serve_unit

torch.set_num_threads(1)
LENGTHS = [60, 30, 55, 100, 42, 77, 50, 88]


@pytest.fixture(scope="module")
def voc_w(tmp_path_factory):
    """The JAX test's small vocoder (GRU-A 64, GRU-B 16, cond 32, embed
    16), drawn by the JAX package, as an .npz."""
    m = JLPCNet(gru_a_units=64, gru_b_units=16, cond_dim=32, embed_dim=16)
    p = m.init(jax.random.PRNGKey(2))
    path = tmp_path_factory.mktemp("voc") / "voc_small.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in p.items()})
    return str(path)


@pytest.fixture
def world1():
    """A world-1 gloo group, as make_mesh starts it, torn down after."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world1_words(voc_w):
    """What the unit publishes at world 1, chunked and single-shot, for
    one word of eight distinct slots (tests/torch_dist.py::serve_world's
    inputs)."""
    live, *bg = serve_segments(3, LENGTHS)
    try:
        chunked = serve_unit(voc_w, SlotFeeder(bg), True)
        assert chunked._chunk == 50 and chunked._world == 1
        msg = ClosedLoopMessage(data=live, fs=100, received_at=0.0)

        async def drain():
            return [(s.stream.name, m) async for s, m in chunked.decode(msg)]
        published = asyncio.run(drain())
        lpc_c, = [m.data for s, m in published if s == "LPC"]
        audio_c = [m.data for s, m in published if s == "OUTPUT"]
        c = (lpc_c, np.concatenate(audio_c), dict(chunked.slot_audio))
        single = serve_unit(voc_w, SlotFeeder(bg), False)
        assert single._chunk is None
        lpc, a0, n_chunks, _ = single._head(live)
        assert n_chunks == 1
        s = (lpc, a0, dict(single.slot_audio))
        for u in (chunked, single):
            u.shutdown()
    finally:
        dist.destroy_process_group()
    return dict(chunked=c, single=s, published=published)


def test_distinct_slots_chunked_matches_single_shot(world1_words):
    """8 slots with DIFFERENT segments and lengths: chunked emission (head
    + tails) ships, for EVERY slot, audio bit-identical to the single-shot
    path, trimmed to each slot's own word length; the slots' audio differs
    pairwise."""
    lpc_c, slot0_c, bg_c = world1_words["chunked"]
    lpc_s, slot0_s, bg_s = world1_words["single"]
    # What the subscriber published for the chunked word (Tp 100: a head
    # chunk and one tail): LPC; the first chunk with the word's latency
    # stamps; the last chunk stamped as the word's completion; WORD, the
    # whole word, anonymized.
    published = world1_words["published"]
    assert [s for s, _ in published] == ["LPC", "OUTPUT", "OUTPUT", "WORD"]
    (_, first), (_, last), (_, word) = published[1:]
    assert first.received_at == 0.0 and [k for k, _ in first.stamps] == \
        ["dv_dispatch", "dv_device_done"]
    assert len(first.data) == 50 * 160
    assert last.received_at == 0.0 and [k for k, _ in last.stamps] == \
        ["dv_dispatch", "dv_word_complete"]
    assert word.received_at is None and word.stamps == ()
    np.testing.assert_array_equal(word.data, slot0_c)
    np.testing.assert_array_equal(lpc_c, lpc_s)
    assert lpc_c.shape == (LENGTHS[0], 20)
    np.testing.assert_array_equal(slot0_c, slot0_s)
    assert len(slot0_c) == LENGTHS[0] * 160
    for i in range(1, 8):
        np.testing.assert_array_equal(bg_c[i], bg_s[i])
        assert len(bg_c[i]) == LENGTHS[i] * 160
        n = min(len(slot0_c), len(bg_c[i]))
        assert not np.array_equal(slot0_c[:n], bg_c[i][:n]), f"slot {i}"


def test_per_stream_state_independence(voc_w, world1):
    """A stream's audio depends only on its own segment history: slot 1
    fed [X, Z] in two units whose every other slot (the live one included)
    carries different content gives bit-identical audio for both words;
    the comparison is per slot index, since the noise is keyed by slot.
    Both runs pad each word to the same length (the state advances over a
    slot's repeat-padded tail too).  Single-shot, 10-frame buckets and
    four streams keep the plain sampler's CPU time down; chunking is the
    test above's."""
    X, Z = serve_segments(11, [18, 15])
    liveA = serve_segments(12, [14, 12])
    liveB = serve_segments(13, [19, 11])
    otherA = serve_segments(14, [9, 27])
    otherB = serve_segments(15, [24, 20])

    def feeder(other):
        def feed(n, t):
            word = feed.word
            return [[X, Z][word]] + [other[(word + j) % 2] for j in range(2)]
        return feed

    fA, fB = feeder(otherA), feeder(otherB)
    unitA = serve_unit(voc_w, fA, False, streams=4, length_multiple=10)
    unitB = serve_unit(voc_w, fB, False, streams=4, length_multiple=10)
    words = {}
    for word in (0, 1):
        fA.word = fB.word = word
        for name, unit, live in (("A", unitA, liveA), ("B", unitB, liveB)):
            unit._head(live[word])
            words[name, word] = dict(unit.slot_audio)
        assert len(words["A", word][1]) == [18, 15][word] * 160
        np.testing.assert_array_equal(words["A", word][1],
                                      words["B", word][1])
    # The second word rides on each stream's carried state: the same
    # history gave the same audio above, whatever the other streams
    # carried; a stream with another history gives other audio.
    a, b = words["A", 1][1], words["A", 1][2]
    n = min(len(a), len(b))
    assert not np.array_equal(a[:n], b[:n])
    for u in (unitA, unitB):
        u.shutdown()


def test_slot_feeder_count_mismatch_raises(voc_w, world1):
    unit = serve_unit(voc_w, lambda n, t: serve_segments(5, [20, 20]), True)
    with pytest.raises(ValueError, match="slot_feeder"):
        unit._head(serve_segments(6, [30])[0])
    unit.shutdown()


def test_two_ranks_equal_world_one(voc_w, world1_words, tmp_path):
    """The unit on two gloo ranks (rank 0 the graph's side, rank 1 a
    worker serving slots 4-7): both emission paths publish what world 1
    does, for every slot: the live slot's features bit for bit, every
    slot's audio at its length and within one int16 step of world 1's on
    at least 99% equal samples.  Not bit for bit: each rank decodes its 4
    slots as one packed batch, and the CPU's matrix products round a row
    of a batch of 4 apart from one of 8 (~4e-8), which moves a few samples
    across an int16 rounding edge."""
    r0, r1 = torch_dist.spawn(torch_dist.serve_world, 2, tmp_path, voc_w,
                              LENGTHS)
    assert r0["slots_True"] == (0, 4) and r1["slots_True"] == (4, 8)
    for key in ("chunked", "single"):
        lpc, a0, bg = r0[key]
        want_lpc, want_a0, want_bg = world1_words[key]
        np.testing.assert_array_equal(lpc, want_lpc)
        assert bg.keys() == want_bg.keys()
        for got, want in [(a0, want_a0)] + [(bg[i], want_bg[i]) for i in bg]:
            assert len(got) == len(want)
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.99

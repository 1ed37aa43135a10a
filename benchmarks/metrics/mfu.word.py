"""The word path's share of the card's float32 peak: the model operations
of the words' decode and vocode (counted from their frames; the neural
vocoder's 50-frame calls as K2 at bunch 1, as K3 at the configuration's
bunch above it) over the words' time from segment close to last audio
(host clock), against 67 TFLOP/s."""

from benchmarks import roofline
from benchmarks.metrics_support import kept_tiles


def read(rec, ctx):
    if rec["kind"] != "session" or not rec.get("word_span_s"):
        return None
    flops = 0.0
    for T in rec["word_frames"]:
        flops += roofline.decoder(T)
        if rec["vocoder"] == "dsp":
            flops += roofline.d1(-(-T // 10) * 10)[1]
        else:
            chunks = -(-T // 50)
            flops += chunks * _chunk_flops(ctx)
    span = sum(rec["word_span_s"])
    if span <= 0:
        return None
    return 100.0 * flops / span / roofline.PEAK_F32_FLOPS


def _chunk_flops(ctx) -> float:
    voc = ctx["config"]["vocoder"]
    if voc["bunch"] == 1:
        return roofline.k2(1, 50, kept_tiles(ctx))[1]
    return roofline.k3(1, 50, voc["bunch"], kept_tiles(ctx),
                       voc["gru_a_units"], voc["gru_b_units"],
                       voc["cond_dim"], voc["embed_dim"])[1]

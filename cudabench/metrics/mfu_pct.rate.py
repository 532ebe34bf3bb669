"""Engine, serving plan: the model operations of the audio yielded in the
window (in a traced run its part before the profiled stretch; per frame shipped: an AR step at the session's text length, the NAR
trunks and heads, the Mimi decode; per session whose first chunk fell in
the window: its conditioning) over the window, as a share of the
configuration dtype's peak."""


def read(rec):
    f, c, m = rec["flops"], rec["cfg"]["sopro"], rec["cfg"]["mimi"]
    peak = f.PEAK_FLOPS[rec["cfg"]["compute_dtype"]]
    refs = int(rec["mix"]["refs"]["frames"])
    w0, w1 = rec["span"]
    per_frame = (f.nar_trunk(c, 1) + f.nar_heads(c, 1) + f.mimi_front(m, 1) + f.seanet_decoder(m, 2))
    total = 0.0
    for r in rec["records"]:
        n = sum(k for t, k in zip(r.chunk_t, r.chunk_n) if w0 <= t < w1)
        total += n * (per_frame + f.ar_step(c, len(r.sess.ids)))
        if r.chunk_t and w0 <= r.chunk_t[0] < w1:
            total += f.conditioning(c, 0, len(r.sess.ids), refs)
    return 100.0 * total / (w1 - w0) / peak if total else None

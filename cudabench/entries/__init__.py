"""The program's entries a traffic mix can drive, one module each, found by
the mix's "entry" key (`cudabench.run.load_entry`). Each module gives:

- `run(program, mix, traffic, voices, seconds, hooks)`: set up the entry
  (the family's reference voices made ready for the program among it), warm
  up the shapes the traffic uses, call `hooks["setup_done"]()`, send the
  traffic, and return `hooks["window"](w0, w1, stats)`'s dict with the
  client's `records` and the window's `t0`, `w0`, `w1`, `hop` and `batcher`
  (or None);
- `end_to_end(res, seconds, sr)`: the end-to-end metrics over the window,
  and `res["attempted"]` / `res["failed"]`;
- whatever its family's `reference` asks of it. The Sopro family's:
  `state_frames(mix)`, the frames the program's plan conditions, and
  `plan(s, ctx, state_frames)`, a checked session's NAR windows, as its
  reference works them out again.
"""

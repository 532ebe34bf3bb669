"""The architectures the benchmark runs, one module each, found by the
configuration's "family" key (`cudabench.run.load_family`): a configuration
of a new architecture brings its module as a new file. Each module gives:

- `specs(cfg)`: the weight specs `cudabench.weights.make` draws, one per
  state dict;
- `build(cfg, state_dicts, device, tokenizer)`: the program under test,
  built from those state dicts through the program's own converters;
- `voices(traffic, cfg)`: the reference voices the entry hands the program;
- `sample_rate(cfg)`: the waveform's samples per second;
- `checked(records, mix, voices)`: the `cudabench.check.Checked` of the
  records the check compares;
- `reference(state_dicts, cfg, prec, device, entry, mix)`: the plain
  reference in precision `prec`, an object with `hop` (samples per frame),
  `run(sessions, forces=None, only=None)` (per session a dict with the
  waveform `wav`, its `frames`, and what its `near_ties` reads),
  `near_ties(out, frame, tie, done)` (the decisions that can reach `frame`,
  each (gap, kind, key, runner-up), with a gap under `tie` and (kind, key)
  not in `done`, smallest gap first) and `force(forces, kind, key, code)`
  (a session's forces with one more decision set);
- `flops`: the module the per-layer readers find in `rec["flops"]`.
"""

"""A configuration of another architecture runs through `cudabench.run.main`
from new files alone: its configuration, family module, entry, traffic mix
and limits, written into a checkout beside the benchmark's own files (the
toy family of `cudabench/tests/toy/`), reads correct; the same checkout with
one token planted in the program's output reads not correct. Nothing of the
benchmark's own files is written."""

import json
import os
import shutil

from cudabench import run
from cudabench.tests.small import MIMI, REPO, checkout

TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")
CELL = "toy.single"


def _toy_checkout(tmp):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(REPO, "cudabench", "configs", "sopro-v1.5-fp32.json")) as f:
        mimi = dict(json.load(f)["mimi"], **MIMI)
    bench["configs"].append({"name": "toy", "source": "cudabench/tests/toy/families/toy.py",
                             "file": "cudabench/configs/toy.json", "reduced": [],
                             "why": "a second architecture"})
    bench["workloads"].append({"name": CELL, "config": "toy", "traffic": "toy-single", "chips": 1,
                               "why": "one closed-loop client"})
    cfg = {"family": "toy", "compute_dtype": "float32", "tf32": False, "text_vocab": 64,
           "toy": {"d_model": 16}, "mimi": mimi}
    mix = {"entry": "toy", "loop": "closed", "clients": 1, "lead_s": 0.2, "cycle": 4,
           "refs": {"count": 2, "frames": 6, "zipf": 1.1}, "sampling": {"greedy": True},
           "text_len": [4, 12], "frames": [8, 8], "check": {"sessions": 4, "keep": 1.0}}
    limits = {"tau": 0.01, "wave_err": 2e-5, "tie": 1e-3, "unexplained": 0}
    root = checkout(tmp, {"BENCHMARK.json": bench, "cudabench/configs/toy.json": cfg,
                          "cudabench/traffic/toy-single.json": mix,
                          f"cudabench/limits/{CELL}.json": limits})
    shutil.copytree(TOY, os.path.join(root, "cudabench"), dirs_exist_ok=True)
    return root


def _files():
    """Every file of the benchmark's own, with its size and time."""
    out = {}
    for d, dirs, fs in os.walk(os.path.join(REPO, "cudabench")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in fs:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def _drive(capsys, root, keep):
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace",
                   "0"], device="cpu", root=root, keep=keep)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_second_family_runs_from_new_files_alone(capsys, tmp_path):
    before = _files()
    root = _toy_checkout(tmp_path)
    keep = {}
    line = _drive(capsys, root, keep)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert line["checked"]["sessions_checked"]["value"] == 4
    assert keep["outcome"].wave_err == 0.0 and keep["outcome"].unexplained == 0
    assert set(line["metrics"]) == {"setup_s"}

    toy = os.path.join(root, "cudabench", "families", "toy.py")
    with open(toy) as f:
        src = f.read()
    with open(toy, "w") as f:
        f.write(src.replace("\nPLANT = None\n", "\nPLANT = (1, 0)\n"))
    keep = {}
    line = _drive(capsys, root, keep)
    assert line["correct"] is False and line["failed"] == 0
    # the frame before the planted token agrees; every call diverges after it
    assert keep["outcome"].wave_err == 0.0
    assert keep["outcome"].unexplained == len(keep["checked"]) == 4
    assert all(p["diverged_at"] == 1 for p in keep["outcome"].sessions)
    assert _files() == before


def test_a_configuration_without_its_family_is_refused(tmp_path):
    root = _toy_checkout(tmp_path)
    os.remove(os.path.join(root, "cudabench", "families", "toy.py"))
    try:
        run.load_family(root, {"family": "toy"})
    except ValueError as e:
        assert "cudabench/families/toy.py" in str(e)
    else:
        raise AssertionError("a missing family module was not refused")
    try:
        run.load_family(root, {})
    except ValueError as e:
        assert '"family"' in str(e)
    else:
        raise AssertionError("a configuration without a family was not refused")

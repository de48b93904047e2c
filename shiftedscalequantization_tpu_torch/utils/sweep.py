"""Hyperparameter sweep runner (PyTorch port of
``shiftedscalequantization_tpu/utils/sweep.py``; the reference's
shell-script sweeps, cuda1.sh role: in-process, resumable, logged).

Runs the port's CLI main() over a grid of flag overrides, appends one JSON
line per run to the sweep log, and skips already-completed combos on
resume. The combo ids and records are the JAX sweep's, so a log written
by either package resumes in the other.

Usage:
    python -m shiftedscalequantization_tpu_torch.utils.sweep \\
        --base "--dataset cifar10 --arch resnet18 --skip_test true" \\
        --grid "lmda=0.01,0.1,1.0" --grid "shift_targets=0.96875,1.03125,1.0;0.5,1.0" \\
        --out sweep.jsonl
Grid values are comma-separated; use ';' to separate values that
themselves contain commas (like shift target tuples). A combo whose run
raises is logged with an ``error`` record and counts as done: a caller
that needs every run to succeed reads the records.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import time


def parse_grid(spec: str):
    key, _, vals = spec.partition("=")
    sep = ";" if ";" in vals else ","
    return key, vals.split(sep)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="", help="base CLI flags (one string)")
    ap.add_argument("--grid", action="append", default=[],
                    help="key=v1,v2,... (repeatable; ';' for tuple values)")
    ap.add_argument("--out", default="sweep.jsonl")
    args = ap.parse_args(argv)

    from ..cli import main as cli_main

    keys, value_lists = [], []
    for g in args.grid:
        k, vs = parse_grid(g)
        keys.append(k)
        value_lists.append(vs)

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["combo"])
                except (ValueError, KeyError, TypeError):
                    pass

    base = args.base.split()
    results = []
    for combo in itertools.product(*value_lists):
        combo_id = ",".join(f"{k}={v}" for k, v in zip(keys, combo))
        if combo_id in done:
            print(f"skip (done): {combo_id}")
            continue
        argv_run = list(base)
        for k, v in zip(keys, combo):
            argv_run += [f"--{k}", v]
        print(f"run: {combo_id}")
        t0 = time.time()
        try:
            acc = cli_main(argv_run)
            rec = {"combo": combo_id, "result": acc,
                   "wall_s": round(time.time() - t0, 1)}
        except Exception as e:      # logged per combo; the sweep goes on
            rec = {"combo": combo_id, "error": str(e)[:200],
                   "wall_s": round(time.time() - t0, 1)}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        results.append(rec)
    return results


if __name__ == "__main__":
    main()

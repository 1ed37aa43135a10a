"""Assemble the out-of-family (harmonic-plus-noise) external-eval artifact
(counterpart of tools/score_exteval.py, which made EXTEVAL_r05.json).

* generates the code-independent harmonic-plus-noise corpus
  (tools/make_hnm_corpus.py, run as it is: it imports numpy only) with both
  f0/formant registers: 6 keywords x ``--variants`` prosodic variants x
  {male ~112 Hz, female ~205 Hz};
* round-trips it through a vocoder checkpoint at each temperature of
  ``--temps`` through ``eval/keyword_intelligibility.py::main`` in this
  process (the JAX tool starts that script as a subprocess);
* derives a per-register accuracy / margin breakdown from the pooled run
  (each word's rows arrive as [male x V, female x V]), plus, with
  ``--per-register-cd``, per-register CD / STOI from single-register runs;
* writes one JSON artifact with the JAX tool's keys: the headline report,
  the registers, the temperature sweep and the margin distribution::

    python -m dss_tpu_torch.eval.score_exteval --out EXTEVAL.json \\
        --weights weights/vocoder_speech.npz --seed 515151 \\
        --temps 0.85,1.0,1.15,1.3 --headline-temp 1.0 [--device cpu]

``--device`` takes the place of ``--pallas``.  Three inputs on which the
JAX tool goes wrong fail here before any work, with a message: more than
10 keyword files a word (``--variants`` >= 6: the files sort as strings,
so kw_x_10 comes before kw_x_2 and rows land in the wrong register), a
``--headline-temp`` that is not one of ``--temps``, and a register with
no rows.  On every other input the rows are the JAX tool's.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from . import keyword_intelligibility

REPO = Path(__file__).resolve().parents[2]
REGISTERS = ("male", "female")
MAX_FILES_A_WORD = 10  # kw_<word>_<n>.wav sort as strings past n = 9


def run_eval(corpus_dir: str, weights: str, device, seed: int,
             temp: float) -> dict:
    """One keyword-intelligibility scoring run -> its report (the JSON line
    it prints is kept off stdout)."""
    argv = [str(corpus_dir), "--backend", "net", "--weights", str(weights),
            "--seed", str(seed), "--temperature-scale", str(temp)]
    if device is not None:
        argv += ["--device", str(device)]
    with contextlib.redirect_stdout(io.StringIO()):
        return keyword_intelligibility.main(argv)


def split_registers(report: dict, variants: int) -> dict:
    """Per-register accuracy / margins from a pooled two-register report.

    The report's margin rows come in per-word variant order, and the corpus
    generator writes each word's variants as [male x V, female x V], so a
    row's index within its word gives its register.  Raises on a register
    with no rows; a register whose rows carry no finite margin has no
    margin keys."""
    rows = {reg: [] for reg in REGISTERS}
    count = {}
    for row in report["margins"]:
        i = count.get(row["word"], 0)
        count[row["word"]] = i + 1
        rows["male" if i < variants else "female"].append(row)
    out = {}
    for reg, rs in rows.items():
        if not rs:
            raise ValueError(f"register '{reg}' has no rows in the report: "
                             f"the corpus holds fewer than "
                             f"{variants + 1 if reg == 'female' else 1} "
                             f"keyword files a word")
        margins = [r["margin"] for r in rs
                   if np.isfinite(r.get("margin", np.nan))]
        out[reg] = {
            "n": len(rs),
            "accuracy": round(
                sum(r["predicted"] == r["word"] for r in rs) / len(rs), 4),
            **({"margin_min": round(float(np.min(margins)), 4),
                "margin_median": round(float(np.median(margins)), 4)}
               if margins else {}),
        }
    return out


def check_corpus(corpus_dir: str, variants: int) -> None:
    """Raises, naming the register, if the corpus gives a register no rows:
    the female rows are each word's files past the first ``variants``."""
    words = keyword_intelligibility.collect_keywords(corpus_dir)
    most = max(len(v) for v in words.values())
    if most <= variants:
        raise ValueError(f"register 'female' has no keyword files in "
                         f"{corpus_dir}: at most {most} a word, and the "
                         f"first {variants} are the male register's")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        "Two-register out-of-family eval artifact (HNM corpus).")
    ap.add_argument("--out", default="EXTEVAL.json")
    ap.add_argument("--corpus-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "hnm_exteval"),
                    help="Where to generate (or find, with --reuse-corpus) "
                         "the two-register HNM corpus.")
    ap.add_argument("--reuse-corpus", action="store_true")
    ap.add_argument("--weights", default="weights/vocoder_speech.npz")
    ap.add_argument("--device", default=None,
                    help="Torch device (default: cuda).")
    ap.add_argument("--seed", type=int, default=515151,
                    help="Corpus + sampling seed (unseen by any trainer).")
    ap.add_argument("--variants", type=int, default=2)
    ap.add_argument("--temps", default="0.85,1.0,1.15,1.3",
                    help="temperature_scale sweep; the artifact records "
                         "every point.")
    ap.add_argument("--headline-temp", type=float, default=1.0,
                    help="Which sweep point is the headline (the shipped "
                         "online default is 1.0).")
    ap.add_argument("--per-register-cd", action="store_true",
                    help="Also score each register against only its own "
                         "register's templates (2 extra runs) for "
                         "per-register CD/STOI.")
    ap.add_argument("--cached-sweep", default=None,
                    help="Directory of pre-computed t<temp>.json reports "
                         "(skips re-running those sweep points).")
    args = ap.parse_args(argv)
    args.temps = [float(t) for t in args.temps.split(",")]
    if args.headline_temp not in args.temps:
        ap.error(f"--headline-temp {args.headline_temp:g} is not one of "
                 f"--temps {','.join(f'{t:g}' for t in args.temps)}")
    if args.variants < 1 or args.variants * len(REGISTERS) > MAX_FILES_A_WORD:
        ap.error(f"--variants {args.variants} x {len(REGISTERS)} registers "
                 f"gives {args.variants * len(REGISTERS)} keyword files a "
                 f"word; keyword_intelligibility sorts them as strings, so "
                 f"past {MAX_FILES_A_WORD} the register split is wrong: use "
                 f"1-{MAX_FILES_A_WORD // len(REGISTERS)} variants")
    return args


def main(argv=None) -> dict:
    """Writes the artifact to ``--out`` and returns it."""
    args = parse_args(argv)
    if not args.reuse_corpus:
        subprocess.run(
            [sys.executable, str(REPO / "tools" / "make_hnm_corpus.py"),
             "--out", args.corpus_dir, "--seed", str(args.seed),
             "--variants", str(args.variants),
             "--registers", ",".join(REGISTERS)],
            check=True)

    cached = {t: os.path.join(args.cached_sweep, f"t{t:g}.json")
              for t in args.temps} if args.cached_sweep else {}
    if args.per_register_cd or not all(
            os.path.exists(cached.get(t, "")) for t in args.temps):
        check_corpus(args.corpus_dir, args.variants)
    sweep = []
    reports = {}
    for t in args.temps:
        if os.path.exists(cached.get(t, "")):
            with open(cached[t]) as f:
                rep = json.load(f)
        else:
            rep = run_eval(args.corpus_dir, args.weights, args.device,
                           args.seed, t)
        reports[t] = rep
        sweep.append({
            "temperature_scale": t,
            "keyword_id_accuracy": rep["keyword_id_accuracy"],
            "cepstral_distance_db_mean": rep["cepstral_distance_db_mean"],
            "stoi_mean": rep.get("stoi_mean"),
            "margin_min": rep.get("margin_min"),
            "margin_median": rep.get("margin_median"),
        })
        print(f"temp {t:g}: acc {rep['keyword_id_accuracy']:.3f} "
              f"CD {rep['cepstral_distance_db_mean']:.2f} dB "
              f"margin_med {rep.get('margin_median')}", file=sys.stderr)

    headline = reports[args.headline_temp]
    artifact = dict(headline)
    artifact.update({
        "registers": list(REGISTERS),
        "variants_per_register": args.variants,
        "corpus_seed": args.seed,
        "corpus_generator": "tools/make_hnm_corpus.py (harmonic-plus-noise"
                            ", Hillenbrand-1995 male+female targets; no "
                            "code/tables shared with the training-corpus "
                            "generator)",
        "per_register": split_registers(headline, args.variants),
        "temperature_sweep": sweep,
        "headline_temperature_scale": args.headline_temp,
    })

    if args.per_register_cd:
        for reg, lo in (("male", 0), ("female", args.variants)):
            reg_dir = f"{args.corpus_dir}_{reg}"
            os.makedirs(reg_dir, exist_ok=True)
            for name in sorted(os.listdir(args.corpus_dir)):
                if not name.startswith("kw_"):
                    continue
                word, idx = name[3:-4].rsplit("_", 1)
                idx = int(idx)
                if lo <= idx < lo + args.variants:
                    with open(os.path.join(args.corpus_dir, name), "rb") as f:
                        data = f.read()
                    with open(os.path.join(
                            reg_dir, f"kw_{word}_{idx - lo}.wav"), "wb") as f:
                        f.write(data)
            rep = run_eval(reg_dir, args.weights, args.device, args.seed,
                           args.headline_temp)
            artifact["per_register"][reg].update({
                "own_register_accuracy": rep["keyword_id_accuracy"],
                "cepstral_distance_db_mean":
                    rep["cepstral_distance_db_mean"],
                "stoi_mean": rep.get("stoi_mean"),
            })
            print(f"{reg} own-register: acc "
                  f"{rep['keyword_id_accuracy']:.3f} CD "
                  f"{rep['cepstral_distance_db_mean']:.2f} dB",
                  file=sys.stderr)

    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()

"""The staged replication pipeline on the port (counterpart of
replicate.sh): the same eight stages, run in this process one after the
other, each through the port's own app.

1. contamination analysis: ``eval.aggregate_per_day``,
   ``eval.contamination`` (the surrogates on the device) and the report
   eval/contamination/gen_contamination_report.py, loaded by path (it
   imports only numpy, scipy and matplotlib);
2. corpus preparation (``prepare_corpus``: the front-end kernel once per
   trial extraction);
3. nVAD training (``train_unidirectional_vad``, 8 epochs);
4. decoder training (``train_bidirectional_model``, 20 epochs);
5. the day's normalization statistics (``baseline_offline``);
6. supplementary figure 2 (``eval.suppl_fig_2``);
7. the replay amplifier (``development_amplifier``, 60 s of the online
   session) as a process of its own; when stage 8 follows, it is imported
   at once and held back until the decoder's run log says "starting
   sources" (at most AMP_MAX_WAIT s, after AMP_START_DELAY s);
8. the online decoder (``decode_online``'s system), its int16 PCM written
   to TEMP_DIR/replicate_audio.pcm; it ends on the INI's idle timeout.

Configured as replicate.sh is, by environment variables: DATA_DIR,
NORM_DIR, LIVE_DIR, TEMP_DIR, SETTINGS, FIG_DAY, AMP_START_DELAY,
AMP_MAX_WAIT, and ``stage`` / ``stop_stage``::

    DATA_DIR=... NORM_DIR=... LIVE_DIR=... TEMP_DIR=... SETTINGS=INI \\
        python -m dss_tpu_torch.apps.replicate [--device cpu]

Every stage runs on the card unless ``--device`` says otherwise.

Two packages may be missing where the card is, and neither moves any
computation off it:

* h5py: where it imports, stage 2 writes the ``.hdf`` corpus and stages 3
  and 4 read it, as the JAX pipeline does.  Where it does not, stages 2-4
  must run in one invocation: the corpus goes from stage 2 to both
  trainers in memory, and starting at stage 3 or 4 raises an ImportError
  that names h5py;
* matplotlib: stages 1 and 6 always compute and save their arrays, and
  draw their figures only where it imports; otherwise their log line and
  their result say that no figure was drawn.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import logging
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Optional

import torch

from .. import runtime as ez
from ..eval import aggregate_per_day, contamination, suppl_fig_2
from ..utils import hdf
from . import baseline_offline, decode_online, prepare_corpus, \
    train_bidirectional_model, train_unidirectional_vad

logger = logging.getLogger("replicate.py")

REPO = Path(__file__).resolve().parents[2]
TEST_DAY = "2022_11_03"
VAL_DAY = "2022_11_04"
VAD_EPOCHS = 8
DECODER_EPOCHS = 20
ONLINE_DAY = "2023_04_14"
REPLAY_SECONDS = 60
LOG_FORMAT = "[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s"


@dataclass
class ReplicateConfig:
    data_dir: Path
    norm_dir: Path
    live_dir: Path
    temp_dir: Path
    settings: Path
    stage: int = 1
    stop_stage: int = 8
    fig_day: str = "2022_09_22"
    amp_start_delay: float = 0.0
    amp_max_wait: float = 900.0
    device: Optional[str] = None

    @classmethod
    def from_env(cls, env: Mapping[str, str], device=None
                 ) -> "ReplicateConfig":
        """replicate.sh's variables and defaults."""
        data_dir = Path(env.get("DATA_DIR", "/data/KeywordReading"))
        return cls(
            data_dir=data_dir,
            norm_dir=Path(env.get("NORM_DIR", "/data/SyllableRepetition")),
            live_dir=Path(env.get("LIVE_DIR",
                                  "/data/KeywordReading/online_sessions")),
            temp_dir=Path(env.get("TEMP_DIR", Path(tempfile.gettempdir())
                                  / "ReplicateDelayedSynthesis")),
            settings=REPO / env.get("SETTINGS",
                                    "config/debug_settings.ini"),
            stage=int(env.get("stage", 1)),
            stop_stage=int(env.get("stop_stage", 8)),
            fig_day=env.get("FIG_DAY", "2022_09_22"),
            amp_start_delay=float(env.get("AMP_START_DELAY", 0)),
            amp_max_wait=float(env.get("AMP_MAX_WAIT", 900)),
            device=device)


def have_h5py() -> bool:
    try:
        hdf._h5py()
    except ImportError:
        return False
    return True


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


@contextlib.contextmanager
def stage_log(path: Path):
    """Copy every INFO record of the process into ``path`` (truncated
    first) while the block runs: the log file each app writes when it is
    run on its own."""
    root = logging.getLogger()
    handler = logging.FileHandler(path, "w+")
    handler.setFormatter(logging.Formatter(LOG_FORMAT, "%d.%m.%y %H:%M:%S"))
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
        handler.close()


def contamination_report(contamination_dir: Path, out_dir: Path) -> Path:
    """eval/contamination/gen_contamination_report.py, loaded from its
    path and run on ``contamination_dir``'s aggregated_by_day/ and
    analysis/ folders; -> the PNG it writes."""
    path = REPO / "eval" / "contamination" / "gen_contamination_report.py"
    spec = importlib.util.spec_from_file_location("gen_contamination_report",
                                                  path)
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    report.main(contamination_dir / "aggregated_by_day",
                contamination_dir / "analysis", out_dir)
    return out_dir / "contamination_report.png"


def gated_amplifier(run_log: Optional[str], start_delay: float,
                    max_wait: float, argv) -> None:
    """The replay amplifier held back until ``run_log`` says "starting
    sources" (polled every 0.5 s, at most ``max_wait`` s, after
    ``start_delay`` s); without ``run_log`` it streams at once.  It is
    imported (torch, scipy: seconds) before the wait and then says
    "imported" on stdout, which it hands to stderr after that: the stage
    starts the decoder only then, so that the amplifier's start-up cannot
    eat into the decoder's idle window."""
    from . import development_amplifier

    print("imported", flush=True)
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
    time.sleep(start_delay)
    if run_log:
        waited = 0.0
        while not (os.path.exists(run_log) and "starting sources"
                   in Path(run_log).read_text(errors="replace")):
            time.sleep(0.5)
            waited += 0.5
            if waited >= max_wait:
                break
    development_amplifier.main(argv)


class Replication:
    """One invocation of the pipeline: ``run()`` runs stages ``stage`` ..
    ``stop_stage`` and returns each stage's result by number."""

    def __init__(self, cfg: ReplicateConfig):
        self.cfg = cfg
        self.corpus_dir = cfg.temp_dir / "corpus"
        self.corpus = None     # the in-memory corpus of stage 2
        self.amplifier = None  # stage 7's process

    def run(self) -> dict:
        cfg = self.cfg
        stages = {1: self.stage_1, 2: self.stage_2, 3: self.stage_3,
                  4: self.stage_4, 5: self.stage_5, 6: self.stage_6,
                  7: self.stage_7, 8: self.stage_8}
        results = {}
        try:
            for n in range(max(cfg.stage, 1), min(cfg.stop_stage, 8) + 1):
                t0 = time.perf_counter()
                results[n] = stages[n]()
                if torch.device(cfg.device or "cuda").type == "cuda":
                    torch.cuda.synchronize()
                results[n]["seconds"] = time.perf_counter() - t0
                logger.info("Stage %d done in %.1f s", n,
                            results[n]["seconds"])
        finally:
            amp = self.amplifier
            if amp is not None and amp.poll() is None:
                amp.kill()
                amp.wait()
        return results

    def stage_1(self) -> dict:
        logger.info("Stage 1: Running the contamination analysis part")
        base = self.cfg.temp_dir / "contamination"
        agg, timings = base / "aggregated_by_day", base / "timings"
        aggregate_per_day.main(["--corpus-root", str(self.cfg.data_dir),
                                "--acc-path", str(agg),
                                "--timing-path", str(timings)])
        analysis = base / "analysis"
        contamination.main(["--agg-path", str(agg), "--out", str(analysis)]
                           + (["--device", self.cfg.device]
                              if self.cfg.device else []))
        out = self.cfg.temp_dir / "analysis"
        out.mkdir(parents=True, exist_ok=True)
        figure = None
        if have_matplotlib():
            figure = contamination_report(base, out)
        else:
            logger.warning("matplotlib is not installed: the contamination "
                           "report (contamination_report.png) is not drawn; "
                           "the results are in %s", analysis)
        return dict(days=sorted(p.name.split("_KeywordReading")[0]
                                for p in agg.glob("*_KeywordReading_Overt.mat")),
                    results=sorted(str(p) for p in
                                   analysis.glob("*_contamination_result.mat")),
                    figure=figure)

    def stage_2(self) -> dict:
        logger.info("Stage 2: Precompute features for train, validation and "
                    "test set")
        self.corpus_dir.mkdir(parents=True, exist_ok=True)
        args = (self.corpus_dir, self.cfg.norm_dir, [self.cfg.data_dir],
                self.cfg.device)
        if have_h5py():
            corpus = prepare_corpus.main(*args)
        else:
            corpus = self.corpus = prepare_corpus.prepare(*args)
            logger.warning("h5py is not installed: the corpus is kept in "
                           "memory for stages 3 and 4, not written")
        return dict(recordings=sorted(corpus), in_memory=self.corpus
                    is not None,
                    trials=int(sum(len(set(r["trial_ids"].tolist()))
                                   for r in corpus.values())))

    def _recordings(self):
        """The corpus for stages 3 and 4: stage 2's in memory, else the
        .hdf files under the corpus directory, which need h5py."""
        if self.corpus is None and not have_h5py():
            raise ImportError(
                "stages 3 and 4 read the .hdf corpus, and h5py is not "
                "installed: run stages 2-4 in one invocation (stage=2), "
                "which keeps the corpus in memory")
        return self.corpus

    def _train(self, app, out_name: str, epochs: int) -> dict:
        recordings = self._recordings()
        out = self.cfg.temp_dir / out_name
        out.mkdir(parents=True, exist_ok=True)
        cfg = app.parse_config(
            [str(self.corpus_dir), str(out), "--test_day", TEST_DAY,
             "--val_day", VAL_DAY, "--epochs", str(epochs)]
            + (["--device", self.cfg.device] if self.cfg.device else []))
        with stage_log(out / "training.log"):
            history = app.main(cfg, recordings)
        return dict(history=history, out_dir=str(out))

    def stage_3(self) -> dict:
        logger.info("Stage 3: Train nVAD model")
        return self._train(train_unidirectional_vad, "nVAD", VAD_EPOCHS)

    def stage_4(self) -> dict:
        logger.info("Stage 4: Train bidirectional decoding model")
        return self._train(train_bidirectional_model, "decoding_model",
                           DECODER_EPOCHS)

    def stage_5(self) -> dict:
        logger.info("Stage 5: Compute day specific normalization statistics")
        session_dir, norm_file = baseline_offline.get_paths(
            str(self.cfg.settings))
        if norm_file is None:
            raise ValueError(f"{self.cfg.settings}: no normalization_file "
                             f"in [Normalization]")
        os.makedirs(session_dir, exist_ok=True)  # --overwrite
        with stage_log(Path(session_dir) / "log.normalization.txt"):
            stats = baseline_offline.main(session_dir, norm_file,
                                          self.cfg.device)
        return dict(path=os.path.join(session_dir, "normalization.npy"),
                    shape=list(stats.shape))

    def stage_6(self) -> dict:
        logger.info("Stage 6: Generate supplementary figure 2")
        day = self.cfg.fig_day
        out = suppl_fig_2.gen_power_spectral_analysis_figure(
            self.cfg.data_dir / day / "KeywordReading_Overt_R01.mat",
            self.cfg.norm_dir / day / "SyllableRepetition_Overt.mat",
            out_dir=self.cfg.temp_dir / "analysis", device=self.cfg.device)
        return dict(arrays_path=str(out["arrays_path"]),
                    figure=out["figure"], trials_used=out["trials_used"],
                    shape=list(out["chan_specs"].shape))

    def stage_7(self) -> dict:
        logger.info("Stage 7: Play one file from the online test days "
                    "locally (%d seconds)", REPLAY_SECONDS)
        cfg = self.cfg
        settings = decode_online.build_settings(
            str(cfg.settings), "replicate", cfg.device)
        gated = cfg.stop_stage >= 8
        run_log = Path(settings.destination_dir) / "log.run.txt"
        if gated:
            run_log.unlink(missing_ok=True)  # a stale log would open the gate
        mat = cfg.live_dir / ONLINE_DAY / "KeywordSynthesis_Overt_R01.mat"
        argv = [str(mat.resolve()), "--seconds", str(REPLAY_SECONDS),
                "--port", str(settings.port),
                "--package_size", str(settings.package_size)]
        cfg.temp_dir.mkdir(parents=True, exist_ok=True)
        log_path = cfg.temp_dir / "amplifier.log"
        with open(log_path, "w") as log:
            self.amplifier = subprocess.Popen(
                [sys.executable, "-c",
                 "import sys; from dss_tpu_torch.apps.replicate import "
                 "gated_amplifier as g; g(sys.argv[1] or None, "
                 "float(sys.argv[2]), float(sys.argv[3]), sys.argv[4:])",
                 str(run_log) if gated else "", str(cfg.amp_start_delay),
                 str(cfg.amp_max_wait), *argv],
                cwd=REPO, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=log, text=True)
        with self.amplifier.stdout as out:
            ready = out.readline().strip()
        if ready != "imported":
            self.amplifier.kill()
            self.amplifier.wait()
            raise RuntimeError(f"the amplifier did not start: see {log_path}")
        if not gated:
            self._wait_amplifier()
        return dict(argv=argv, gated=gated, log=str(log_path))

    def _wait_amplifier(self) -> int:
        rc = self.amplifier.wait(timeout=self.cfg.amp_start_delay
                                 + self.cfg.amp_max_wait + REPLAY_SECONDS
                                 + 120)
        if rc != 0:
            raise RuntimeError(f"the amplifier exited {rc}: see "
                               f"{self.cfg.temp_dir / 'amplifier.log'}")
        return rc

    def stage_8(self) -> dict:
        logger.info("Stage 8: Starting online decoder")
        settings = decode_online.build_settings(
            str(self.cfg.settings), "replicate", self.cfg.device)
        os.makedirs(settings.destination_dir, exist_ok=True)  # --overwrite
        pcm = self.cfg.temp_dir / "replicate_audio.pcm"
        logger.info("Writing PCM to %s", pcm)
        with stage_log(Path(settings.destination_dir) / "log.run.txt"), \
                open(pcm, "w") as fd, contextlib.redirect_stdout(fd):
            ez.run_system(decode_online.Neuroprosthesis(settings))
        out = dict(run_dir=settings.destination_dir, pcm=str(pcm),
                   pcm_bytes=pcm.stat().st_size)
        if self.amplifier is not None:
            out["amplifier_rc"] = self._wait_amplifier()
        return out


def main(argv=None, env: Optional[Mapping[str, str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        description="The staged replication pipeline (replicate.sh) on the "
                    "PyTorch/CUDA port; configured by replicate.sh's "
                    "environment variables.")
    parser.add_argument("--device", default=None,
                        help="Torch device of every stage (default: cuda).")
    args = parser.parse_args(argv)
    cfg = ReplicateConfig.from_env(os.environ if env is None else env,
                                   device=args.device)
    return Replication(cfg).run()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT,
                        datefmt="%d.%m.%y %H:%M:%S")
    main()

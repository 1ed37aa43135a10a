"""Synthetic BCI2000 recording days for the port's corpus and training
tests (the days of tests/test_apps.py, with optional extra fields such as
``bad_channels`` and ``contaminated_electrodes``)."""

import numpy as np
from scipy.io import savemat
from scipy.io.wavfile import write as wavwrite

FS = 1000
FS_AUDIO = 16000
DAYS = ("2022_11_02", "2022_11_03", "2022_11_04")


def make_day(day_dir, n_trials=3, seed=0, kind="keyword", extra=None):
    """One day: a KeywordReading .mat + aligned .wav pair (data dir) or a
    SyllableRepetition .mat (normalization dir); ``extra`` fields are
    added to the .mat."""
    rng = np.random.default_rng(seed)
    day_dir.mkdir(parents=True, exist_ok=True)

    trial_len = 3 * FS  # satisfies min_trial_length=2.5 s
    gap = FS
    T = n_trials * (trial_len + gap) + gap
    code = np.zeros(T, np.int16)
    for i in range(n_trials):
        start = gap + i * (trial_len + gap)
        code[start:start + trial_len] = (i % 2) + 1

    signal = rng.normal(size=(T, 129))
    mat = {
        "signal": signal,
        "parameters": {
            "SamplingRate": {"NumericValue": FS},
            "SourceChGain": {"NumericValue": np.ones(129)},
            # BCI2000 stores Stimuli as a cell matrix; row 0 = captions.
            "Stimuli": {"Value": np.array(
                [["Enter", "Right"], ["1", "2"]], dtype=object)},
        },
        "states": {"StimulusCode": code},
        **(extra or {}),
    }
    if kind == "keyword":
        savemat(str(day_dir / "KeywordReading_Overt_R01.mat"), mat)
        audio = (rng.normal(size=int(T * FS_AUDIO / FS)) * 3000).astype(np.int16)
        # A louder stretch in each trial, so that the energy VAD labels
        # speech and silence.
        for i in range(n_trials):
            a = int((gap + i * (trial_len + gap) + 1000) * FS_AUDIO / FS)
            audio[a:a + FS_AUDIO] *= 8
        wavwrite(str(day_dir / "KeywordReading_Overt_R01.wav"), FS_AUDIO, audio)
        return

    # SyllableRepetition: presentation/speaking alternation.
    sr_code = np.zeros(8 * FS, np.int16)
    sr_code[FS:2 * FS] = 1
    sr_code[3 * FS:4 * FS] = 1
    sr = dict(mat)
    sr["signal"] = rng.normal(size=(8 * FS, 129))
    sr["states"] = {"StimulusCode": sr_code}
    sr["parameters"] = dict(mat["parameters"])
    sr["parameters"]["Stimuli"] = {"Value": np.array(
        [["ba"], ["1"]], dtype=object)}
    savemat(str(day_dir / "SyllableRepetition_Overt.mat"), sr)


def make_corpus_days(base, n_trials=3, contaminated_day=None):
    """Three keyword days under base/KeywordReading and their
    normalization days under base/SyllableRepetition; the day named by
    ``contaminated_day`` flags bad and contaminated channels."""
    data_dir = base / "KeywordReading"
    norm_dir = base / "SyllableRepetition"
    for i, day in enumerate(DAYS):
        extra = None
        if day == contaminated_day:
            extra = {"bad_channels": np.array(["chan19", "chan70"],
                                              dtype=object),
                     "contaminated_electrodes": np.array([38, 100])}
        make_day(data_dir / day, n_trials=n_trials, seed=i, kind="keyword",
                 extra=extra)
        make_day(norm_dir / day, seed=10 + i, kind="syllable")
    return data_dir, norm_dir

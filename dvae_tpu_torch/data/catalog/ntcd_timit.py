"""NTCD-TIMIT corpus catalog: pure path-list builders (port copy of
``dvae_tpu.data.catalog.ntcd_timit``, which redesigns the reference's
``packages/dataset/ntcd_timit.py`` with identical outputs):

* directory schema: ``ntcd_timit/matlab_raw/<split>/<spk>/<utt>.mat`` for
  video, ``ntcd_timit/Clean/<split>/<spk>/<utt>*`` for processed clean
  audio/labels, ``ntcd_timit/u/drspeech/data/TCDTIMIT/Noisy_TCDTIMIT/
  <noise>/<snr>/volunteers/<spk>/straightcam/<utt>.wav`` for raw noisy, and
  ``ntcd_timit/Noisy/<noise>/<snr>/<split>/<spk>/<utt>.wav`` for processed
  noisy;
* split naming: 'train'/'validation'/'test' -> train/dev/test dirs
  (ntcd_timit.py:38-47);
* grids: 6 noise types x SNRs ['-5','0','5','10','15'] (:330-336,441-447),
  noisy_speech_dict uses SNRs up to '10' only (:246); the 'subset' size
  narrows to ['Babble','LR'] x ['-5'] (:354-359).

All returned paths are relative to the given input dir, like the reference.
A per-utterance label file or lip video is the JAX builder's ``.h5`` or the
``.npz`` of the same array (``data/io.py``); the walks over them take
either, one entry per utterance, the ``.h5`` where both exist.
"""

from __future__ import annotations

import os
import pathlib
from glob import glob

from dvae_tpu_torch.data.io import ARRAY_SUFFIXES

NOISE_TYPES = ["Babble", "Cafe", "Car", "LR", "Street", "White"]
SNRS = ["-5", "0", "5", "10", "15"]
SNRS_NOISY_SPEECH = ["-5", "0", "5", "10"]  # noisy_speech_dict grid (:246)
SUBSET_NOISE_TYPES = ["Babble", "LR"]
SUBSET_SNRS = ["-5"]

_SPLIT_DIR = {"train": "train", "validation": "dev", "test": "test"}


def _split(dataset_type: str) -> str:
    try:
        return _SPLIT_DIR[dataset_type]
    except KeyError:
        raise ValueError(f"unknown dataset_type {dataset_type!r}") from None


def _grids(dataset_size: str, snrs=None):
    if dataset_size == "subset":
        return SUBSET_NOISE_TYPES, SUBSET_SNRS
    return NOISE_TYPES, snrs or SNRS


def _mat_files(root: str, dataset_type: str) -> list[str]:
    d = os.path.join(root, "ntcd_timit/matlab_raw", _split(dataset_type))
    return sorted(glob(os.path.join(d, "**/*.mat"), recursive=True))


def _shortpath(path, suffix=".wav") -> str:
    """last 3 components (<split>/<spk>/<utt>) with new extension."""
    p = pathlib.Path(path)
    return str(pathlib.Path(*p.parts[-3:]).with_suffix(suffix))


def _spk_utt(path, suffix=".wav") -> str:
    """<spk>/straightcam/<utt>.wav from a .mat path."""
    p = pathlib.Path(path)
    return f"{p.parts[-2]}/straightcam/{p.stem}{suffix}"


def video_list(input_video_dir, dataset_type="train", labels="vad_labels", upsampled=False):
    """Relative paths of the split's lip-ROI .mat files (ntcd_timit.py:18-55)."""
    files = _mat_files(input_video_dir, dataset_type)
    return [os.path.relpath(p, input_video_dir) for p in files]


def kaldi_list(input_video_dir, dataset_type="train", labels="vad_labels", upsampled=False):
    """(ark, scp) path lists under kaldi_fMLLR (ntcd_timit.py:57-96)."""
    d = os.path.join(input_video_dir, "ntcd_timit/kaldi_fMLLR", _split(dataset_type))
    ark = sorted(glob(os.path.join(d, "**/*.ark"), recursive=True))
    scp = sorted(glob(os.path.join(d, "**/*.scp"), recursive=True))
    rel = lambda ps: [os.path.relpath(p, input_video_dir) for p in ps]
    return rel(ark), rel(scp)


def speech_list(input_speech_dir, dataset_type="train"):
    """(raw clean wav paths, processed clean wav paths), keyed off the .mat
    inventory (ntcd_timit.py:98-146)."""
    mats = _mat_files(input_speech_dir, dataset_type)
    file_paths = [f"ntcd_timit/Clean/volunteers/{_spk_utt(m)}" for m in mats]
    output_file_paths = [os.path.join("ntcd_timit/Clean", _shortpath(m)) for m in mats]
    return file_paths, output_file_paths


def proc_video_audio_pair_dict(input_video_dir, dataset_type="train",
                               labels="vad_labels", upsampled=False,
                               dct=False, norm_video=False):
    """(video h5 paths, audio label h5 paths) for a split (ntcd_timit.py:149-191).

    With ``upsampled``, the builder's lip videos ``<utt>_upsampled.h5`` or
    ``.npz`` and the label files ``<utt>_<labels>.h5`` or ``.npz``, one entry
    per utterance each (the ``.h5`` where both exist, in the JAX catalog's
    order); otherwise ``.h5`` files alone, as in the JAX catalog."""
    video_dir = os.path.join(input_video_dir, "ntcd_timit/matlab_raw", _split(dataset_type))
    audio_dir = os.path.join(input_video_dir, "ntcd_timit/Clean", _split(dataset_type))
    rel = lambda ps: [os.path.relpath(p, input_video_dir) for p in ps]
    if upsampled:
        return (rel(label_files(video_dir, "_upsampled")),
                rel(label_files(audio_dir, f"_{labels}")))
    if dct:
        pattern = "**/*_dct.h5"
    elif norm_video:
        pattern = "**/*_normvideo.h5"
    else:
        pattern = "**/*.h5"
    video = sorted(glob(os.path.join(video_dir, pattern), recursive=True))
    if pattern == "**/*.h5":  # plain: exclude all derived variants
        video = [v for v in video if not any(s in v for s in ("_upsampled", "_dct", "_normvideo"))]
    audio = sorted(glob(os.path.join(audio_dir, f"**/*_{labels}.h5"), recursive=True))
    return rel(video), rel(audio)


def noisy_speech_dict(input_speech_dir, dataset_type="train", dataset_size="complete"):
    """{raw noisy wav -> processed noisy wav} over the noise x SNR grid
    (ntcd_timit.py:193-281)."""
    mats = _mat_files(input_speech_dir, dataset_type)
    ins = [_spk_utt(m) for m in mats]
    outs = [_shortpath(m) for m in mats]
    noise_types, snrs = _grids(dataset_size, SNRS_NOISY_SPEECH)
    pairs = {}
    for noise in noise_types:
        for snr in snrs:
            in_dir = os.path.join(
                "ntcd_timit/u/drspeech/data/TCDTIMIT/Noisy_TCDTIMIT", noise, snr, "volunteers"
            )
            out_dir = os.path.join("ntcd_timit", "Noisy", noise, snr)
            pairs.update({
                os.path.join(in_dir, i): os.path.join(out_dir, o)
                for i, o in zip(ins, outs)
            })
    return pairs


def noisy_clean_pair_dict(input_speech_dir, dataset_type="train", dataset_size="complete"):
    """{raw noisy wav -> processed clean wav} (ntcd_timit.py:285-382)."""
    mats = _mat_files(input_speech_dir, dataset_type)
    ins = [_spk_utt(m) for m in mats]
    clean_dir = os.path.join("ntcd_timit/Clean", _split(dataset_type))
    noise_types, snrs = _grids(dataset_size)
    pairs = {}
    for noise in noise_types:
        for snr in snrs:
            in_dir = os.path.join(
                "ntcd_timit/u/drspeech/data/TCDTIMIT/Noisy_TCDTIMIT", noise, snr, "volunteers"
            )
            for i in ins:
                noisy = os.path.join(in_dir, i)
                spk = noisy.split("/")[-3]
                clean = os.path.join(clean_dir, spk, os.path.basename(noisy))
                pairs[noisy] = clean
    return pairs


def label_files(clean_dir: str, suffix: str) -> list[str]:
    """The per-utterance files (labels or lip videos) ``*<suffix>.h5`` /
    ``*<suffix>.npz`` under ``clean_dir``, one per utterance (the ``.h5``
    where both exist), sorted by their paths without the extension: for a
    tree of ``.h5`` files alone, the JAX catalog's sorted glob."""
    found = {}
    for ext in reversed(ARRAY_SUFFIXES):  # the .h5 last, so that it wins
        for p in glob(os.path.join(clean_dir, f"**/*{suffix}{ext}"), recursive=True):
            found[p[:-len(ext)]] = p
    return [found[k] for k in sorted(found)]


def proc_noisy_clean_pair_dict(input_speech_dir, dataset_type="train",
                               dataset_size="complete", labels="vad_labels",
                               upsampled=False):
    """{processed noisy wav -> clean label file} (ntcd_timit.py:386-474)."""
    clean_dir = os.path.join(input_speech_dir, "ntcd_timit/Clean", _split(dataset_type))
    suffix = f"{labels}_upsampled" if upsampled else labels
    clean_files = label_files(clean_dir, suffix)
    shortpaths = []
    for c in clean_files:
        p = pathlib.Path(c)
        short = str(pathlib.Path(*p.parts[-3:]).with_suffix(""))
        short = short.replace(f"_{labels}_upsampled" if upsampled else f"_{labels}", "")
        shortpaths.append(short + ".wav")
    clean_rel = [os.path.relpath(p, input_speech_dir) for p in clean_files]
    noise_types, snrs = _grids(dataset_size)
    pairs = {}
    for noise in noise_types:
        for snr in snrs:
            noisy_dir = os.path.join("ntcd_timit", "Noisy", noise, snr)
            pairs.update({
                os.path.join(noisy_dir, s): c for s, c in zip(shortpaths, clean_rel)
            })
    return pairs


def video_h5_rel(label_rel: str, labels: str = "vad_labels") -> str:
    """Clean/<split>/<spk>/<utt>_<labels>_upsampled.{h5,npz} -> its
    matlab_raw/ lip video of the same suffix, the reference's
    Clean<->matlab_raw path substitution (data_handling.py:299-304). One
    home for the rewrite; the reverse is :func:`label_h5_rel`."""
    rel = label_rel.replace("/Clean/", "/matlab_raw/")
    for ext in ARRAY_SUFFIXES:
        rel = rel.replace(f"_{labels}_upsampled{ext}", f"_upsampled{ext}")
    return rel


def label_h5_rel(video_rel: str, labels: str = "vad_labels") -> str:
    """matlab_raw/<split>/<spk>/<utt>_upsampled.{h5,npz} -> its Clean/ label
    file of the same suffix (the inverse of :func:`video_h5_rel`)."""
    rel = video_rel.replace("/matlab_raw/", "/Clean/")
    for ext in ARRAY_SUFFIXES:
        rel = rel.replace(f"_upsampled{ext}", f"_{labels}_upsampled{ext}")
    return rel

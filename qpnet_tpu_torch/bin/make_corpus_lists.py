"""Generate scp file lists + a pow_f0_dict.yml template (the port's copy of
`qpnet_tpu/bin/make_corpus_lists.py`, the same bytes) for a corpus laid
out as `<corpus_dir>/wav/<subset>/<speaker>/<utt>.wav` (the VCC2018
convention the reference ships as static assets; corpus/VCC2018/scp/).

Lists use the `rootpath/wav/...` convention so the orchestrators' temp-list
rewriting works identically.  Per-speaker lists are emitted as
`<prefix>_<SPK>.scp`; f0_min/f0_max/pow_th in the conf template must be
curated by a human after running runFE step 1 (histograms), exactly as in
the reference workflow (README.md:77-83).
"""

from __future__ import annotations

import argparse
import os

from qpnet_tpu_torch.data.lists import find_files, write_txt
from qpnet_tpu_torch.utils import yamlconf

# The reference ships hand-curated per-speaker F0 search ranges and power
# thresholds for the VCC2018 roster (corpus/VCC2018/conf/pow_f0_dict.yml —
# the values a human reads off the runFE step-1 histograms).  Reproduced
# here as data so a VCC2018 user gets the exact reference analysis
# settings without re-curating; unknown speakers still get the wide-open
# defaults below.
VCC2018_POW_F0 = {
    "VCC2SF1": {"f0_min": 100, "f0_max": 450, "pow_th": -31},
    "VCC2SF2": {"f0_min": 110, "f0_max": 350, "pow_th": -31},
    "VCC2SF3": {"f0_min": 110, "f0_max": 340, "pow_th": -38},
    "VCC2SF4": {"f0_min": 120, "f0_max": 330, "pow_th": -34},
    "VCC2SM1": {"f0_min": 50, "f0_max": 200, "pow_th": -31},
    "VCC2SM2": {"f0_min": 70, "f0_max": 300, "pow_th": -40},
    "VCC2SM3": {"f0_min": 45, "f0_max": 220, "pow_th": -35},
    "VCC2SM4": {"f0_min": 45, "f0_max": 260, "pow_th": -32},
    "VCC2TF1": {"f0_min": 140, "f0_max": 350, "pow_th": -45},
    "VCC2TF2": {"f0_min": 100, "f0_max": 400, "pow_th": -30},
    "VCC2TM1": {"f0_min": 60, "f0_max": 200, "pow_th": -23},
    "VCC2TM2": {"f0_min": 50, "f0_max": 280, "pow_th": -31},
}


# The VCC2018 recipe's list inventory is fully deterministic (reference
# corpus/VCC2018/scp/ — 44 checked-in lists): source/target speakers on the
# 1xxxx utterance series, adaptation-era speakers on 2xxxx, training ids
# 1..81, validation 1..10, SD-update 11..81, evaluation/reference 30001..35.
_VCC18_SERIES = {"VCC2SF1": 1, "VCC2SF2": 1, "VCC2SM1": 1, "VCC2SM2": 1,
                 "VCC2TF1": 1, "VCC2TF2": 1, "VCC2TM1": 1, "VCC2TM2": 1,
                 "VCC2SF3": 2, "VCC2SF4": 2, "VCC2SM3": 2, "VCC2SM4": 2}
_VCC18_ADAPT = ["VCC2SF3", "VCC2SF4", "VCC2SM3", "VCC2SM4",
                "VCC2TF1", "VCC2TF2", "VCC2TM1", "VCC2TM2"]
_VCC18_SOURCE = ["VCC2SF1", "VCC2SF2", "VCC2SF3", "VCC2SF4",
                 "VCC2SM1", "VCC2SM2", "VCC2SM3", "VCC2SM4"]
_VCC18_TARGET = ["VCC2TF1", "VCC2TF2", "VCC2TM1", "VCC2TM2"]


def _vcc18_paths(subset: str, spk: str, base: int, ids) -> list:
    return [f"rootpath/wav/{subset}/{spk}/{base + i:05d}.wav" for i in ids]


def write_vcc18_assets(corpus_dir: str) -> None:
    """Write the exact VCC2018 scp inventory + curated pow_f0_dict.yml
    (reference corpus/VCC2018/{scp,conf} static assets, regenerated from
    the ranges above instead of vendoring 3.4k path lines)."""
    scp_dir = os.path.join(corpus_dir, "scp")
    os.makedirs(scp_dir, exist_ok=True)
    groups = {"vcc18tr": [], "vcc18eval": [], "vcc18ref": []}
    for spk in sorted(_VCC18_SERIES):
        base = _VCC18_SERIES[spk] * 10000
        tr = _vcc18_paths("vcc2018_training", spk, base, range(1, 82))
        write_txt(os.path.join(scp_dir, f"vcc18tr_{spk}.scp"), tr)
        groups["vcc18tr"] += tr
        if spk in _VCC18_ADAPT:
            write_txt(os.path.join(scp_dir, f"vcc18va_{spk}.scp"),
                      _vcc18_paths("vcc2018_training", spk, base,
                                   range(1, 11)))
            write_txt(os.path.join(scp_dir, f"vcc18up_{spk}.scp"),
                      _vcc18_paths("vcc2018_training", spk, base,
                                   range(11, 82)))
    for spk in _VCC18_SOURCE:
        ev = _vcc18_paths("vcc2018_evaluation", spk, 30000, range(1, 36))
        write_txt(os.path.join(scp_dir, f"vcc18eval_{spk}.scp"), ev)
        groups["vcc18eval"] += ev
    for spk in _VCC18_TARGET:
        rf = _vcc18_paths("vcc2018_reference", spk, 30000, range(1, 36))
        write_txt(os.path.join(scp_dir, f"vcc18ref_{spk}.scp"), rf)
        groups["vcc18ref"] += rf
    for name, lines in groups.items():
        write_txt(os.path.join(scp_dir, f"{name}.scp"), lines)
    conf_path = os.path.join(corpus_dir, "conf", "pow_f0_dict.yml")
    os.makedirs(os.path.dirname(conf_path), exist_ok=True)
    yamlconf.write(conf_path, VCC2018_POW_F0)
    print(f"wrote VCC2018 scp inventory + conf under {corpus_dir}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus_dir", required=True,
                   help="directory containing wav/<subset>/<spk>/*.wav")
    p.add_argument("--subset",
                   help="wav subdirectory, e.g. vcc2018_training")
    p.add_argument("--prefix",
                   help="scp name prefix, e.g. vcc18tr")
    p.add_argument("--make_conf", action="store_true",
                   help="seed conf/pow_f0_dict.yml defaults for new speakers")
    p.add_argument("--vcc18_assets", action="store_true",
                   help="write the full deterministic VCC2018 list "
                        "inventory + curated conf and exit")
    args = p.parse_args(argv)
    if args.vcc18_assets:
        write_vcc18_assets(args.corpus_dir)
        return
    if not args.subset or not args.prefix:
        p.error("--subset and --prefix are required (or use --vcc18_assets)")

    wav_root = os.path.join(args.corpus_dir, "wav", args.subset)
    scp_dir = os.path.join(args.corpus_dir, "scp")
    os.makedirs(scp_dir, exist_ok=True)
    speakers = sorted(d for d in os.listdir(wav_root)
                      if os.path.isdir(os.path.join(wav_root, d)))
    all_lines = []
    for spk in speakers:
        files = sorted(find_files(os.path.join(wav_root, spk), "*.wav"))
        lines = [f.replace(args.corpus_dir.rstrip("/") + "/wav",
                           "rootpath/wav") for f in files]
        write_txt(os.path.join(scp_dir, f"{args.prefix}_{spk}.scp"), lines)
        all_lines += lines
    write_txt(os.path.join(scp_dir, f"{args.prefix}.scp"), all_lines)
    print(f"wrote {len(speakers)} speaker lists + global list to {scp_dir}")

    if args.make_conf:
        conf_path = os.path.join(args.corpus_dir, "conf", "pow_f0_dict.yml")
        os.makedirs(os.path.dirname(conf_path), exist_ok=True)
        conf = yamlconf.read(conf_path) if os.path.exists(conf_path) else {}
        for spk in speakers:
            conf.setdefault(spk, VCC2018_POW_F0.get(
                spk, {"f0_min": 40, "f0_max": 800, "pow_th": -30}))
        yamlconf.write(conf_path, conf)
        print(f"seeded {conf_path}")


if __name__ == "__main__":
    main()

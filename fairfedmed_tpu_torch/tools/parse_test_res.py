"""Aggregate metrics across seed directories from log.txt files (the
port's own copy of ``tools/parse_test_res.py``; numpy only).

Capability parity with the reference's log harvester
(``Dassl/tools/parse_test_res.py:64-160``): given a directory of
``seed*/log.txt`` runs (or ``--multi-exp`` over one more level), scrape every
``* <keyword>: <value>%`` line after the end-of-training marker and report
mean ± std (or 95% CI with ``--ci95``).

Usage::

    python -m fairfedmed_tpu_torch.tools.parse_test_res output/my_experiment [--ci95]
    python -m fairfedmed_tpu_torch.tools.parse_test_res output/experiments --multi-exp
"""

from __future__ import annotations

import argparse
import os
import re
from collections import defaultdict

import numpy as np

END_SIGNAL = "Finish training"


def listdir_nohidden(path):
    return sorted(d for d in os.listdir(path) if not d.startswith("."))


def compute_ci95(values):
    return 1.96 * np.std(values) / np.sqrt(len(values))


def parse_dir(directory: str, keyword: str, ci95: bool = False):
    """Scrape one experiment dir of seed subdirs; returns {metric: mean}."""
    pattern = re.compile(rf"\* {re.escape(keyword)}: ([\.\deE+-]+)%")
    print(f"Parsing files in {directory}")
    per_seed = []
    for subdir in listdir_nohidden(directory):
        fpath = os.path.join(directory, subdir, "log.txt")
        if not os.path.isfile(fpath):
            continue
        value = None
        armed = False
        with open(fpath) as f:
            for line in f:
                line = line.strip()
                if line == END_SIGNAL:
                    armed = True
                m = pattern.search(line)
                if m and armed:
                    value = float(m.group(1))
        if value is not None:
            per_seed.append((fpath, value))

    assert per_seed, f"Nothing found in {directory}"
    values = [v for _, v in per_seed]
    for fpath, v in per_seed:
        print(f"file: {fpath}. {keyword}: {v:.1f}%.")
    avg = float(np.mean(values))
    spread = compute_ci95(values) if ci95 else float(np.std(values))
    print("===")
    print(f"Summary of directory: {directory}")
    print(f"* {keyword}: {avg:.1f}% +- {spread:.1f}%")
    print("===")
    return {keyword: avg}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("directory", type=str)
    parser.add_argument("--ci95", action="store_true")
    parser.add_argument("--multi-exp", action="store_true")
    parser.add_argument("--keyword", default="accuracy", type=str)
    args = parser.parse_args(argv)

    if args.multi_exp:
        final = defaultdict(list)
        for d in listdir_nohidden(args.directory):
            results = parse_dir(os.path.join(args.directory, d), args.keyword, args.ci95)
            for k, v in results.items():
                final[k].append(v)
        print("Average performance")
        for k, vs in final.items():
            print(f"* {k}: {np.mean(vs):.1f}%")
    else:
        parse_dir(args.directory, args.keyword, args.ci95)


if __name__ == "__main__":
    main()

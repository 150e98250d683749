"""Per-client metric harvester (the port's own copy of
``tools/get_mean_std.py``, with ``csv`` and numpy in place of pandas, which
the card's machine lacks): scrape ``log.txt`` files at a chosen federated
round and write mean/std CSVs.

Walks every ``<run>/log.txt`` under a root folder, isolates the metric block
printed after ``local train finish epoch: <epoch>`` for each ``Evaluate on
the client<i>_test set`` section, and writes

* ``epoch{E}_client_metrics.csv``           — client × metric mean/std
* ``epoch{E}_client_metrics_with_avg.csv``  — plus a cross-client average row

byte for byte as the pandas tool's ``to_csv(index=False)`` writes them: the
``client_avg`` rows sorted by metric (``groupby``'s order), each the
compensated (Kahan) mean that pandas' grouped mean takes, floats in their
shortest round-trip form.

Usage::

    python -m fairfedmed_tpu_torch.tools.get_mean_std output/glp_ot_svlora_race --epoch 49
"""

from __future__ import annotations

import argparse
import csv
import os
import re
from collections import defaultdict

import numpy as np

CLIENT_HEADER = re.compile(r"Evaluate on the (client\d+)_test set")
METRIC_LINE = re.compile(r"\* ([\w\d_]+): ([\d.]+|nan)%?")
COLUMNS = ("client", "metric", "mean", "std")


def extract_epoch_metrics(log_content: str, epoch: int):
    """{client: {metric: [values]}} for the block after the chosen epoch's
    'local train finish epoch:' marker (get_mean_std.py:20-45)."""
    parsed = defaultdict(lambda: defaultdict(list))
    in_epoch = False
    current_client = None
    for line in log_content.splitlines():
        if "local train finish epoch:" in line:
            if in_epoch:
                break  # next round started
            if re.search(rf"epoch:\s*{epoch}\b", line):
                in_epoch = True
            continue
        if not in_epoch:
            continue
        m = CLIENT_HEADER.search(line)
        if m:
            current_client = m.group(1)
            continue
        if current_client and line.strip().startswith("*"):
            mm = METRIC_LINE.match(line.strip())
            if mm and mm.group(2) != "nan":
                parsed[current_client][mm.group(1)].append(float(mm.group(2)))
    return parsed


def kahan_mean(values) -> float:
    """pandas' grouped mean: a compensated sum in order, over the count."""
    total = comp = 0.0
    for v in values:
        y = v - comp
        t = total + y
        comp = t - total - y
        total = t
    return total / len(values)


def client_average(records) -> list:
    """One ``client_avg`` row per metric, in sorted metric order: the mean
    over the clients of their means and of their stds."""
    by_metric = defaultdict(list)
    for r in records:
        by_metric[r["metric"]].append(r)
    return [{"client": "client_avg", "metric": metric,
             "mean": kahan_mean([r["mean"] for r in rows]),
             "std": kahan_mean([r["std"] for r in rows])}
            for metric, rows in sorted(by_metric.items())]


def _cell(value) -> str:
    return repr(value) if isinstance(value, float) else str(value)


def write_csv(path: str, records) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        for r in records:
            writer.writerow([_cell(r[c]) for c in COLUMNS])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("root_folder", type=str)
    parser.add_argument("--epoch", type=int, default=49)
    args = parser.parse_args(argv)

    client_metrics = defaultdict(lambda: defaultdict(list))
    for name in sorted(os.listdir(args.root_folder)):
        log_path = os.path.join(args.root_folder, name, "log.txt")
        if not os.path.isfile(log_path):
            continue
        with open(log_path) as f:
            parsed = extract_epoch_metrics(f.read(), args.epoch)
        for client, metrics in parsed.items():
            for metric, values in metrics.items():
                client_metrics[client][metric].extend(values)

    records = [
        {"client": client, "metric": metric,
         "mean": float(np.mean(values)), "std": float(np.std(values))}
        for client, metrics in client_metrics.items()
        for metric, values in metrics.items()
    ]
    if not records:
        raise SystemExit(f"no metrics found under {args.root_folder}")

    out1 = os.path.join(args.root_folder, f"epoch{args.epoch}_client_metrics.csv")
    write_csv(out1, records)
    avg = client_average(records)
    out2 = os.path.join(args.root_folder, f"epoch{args.epoch}_client_metrics_with_avg.csv")
    write_csv(out2, records + avg)
    print(f"wrote {out1}\nwrote {out2}")
    print(f"{'client':>12} {'metric':>12} {'mean':>12} {'std':>12}")
    for r in avg:
        print(f"{r['client']:>12} {r['metric']:>12} {r['mean']:>12.6f} {r['std']:>12.6f}")


if __name__ == "__main__":
    main()

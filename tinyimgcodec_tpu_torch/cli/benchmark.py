"""Benchmark harness: corpus round-trip metrics -> CSV (+ figure).

The measurement of the reference's ``tests/benchmark.py`` (a CSV over the
corpus x 6 qualities) and ``tests/figure.py`` (a 4-panel bar chart over 3
images), with both PSNR formulas: the reference's wrapped-uint8 one and
the correct float one.  The corpus is the 49 numbered GIFs of
``--corpus DIR`` (``1.gif`` ...), or the synthetic corpus without it.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

QUALITIES = [90, 80, 50, 20, 10, 5]  # reference tests/benchmark.py:13
FIGURE_QUALITIES = [90, 80, 50, 20, 10, 5]


def _roundtrip(api, img, quality, backend, device):
    t0 = time.perf_counter()
    data = api.compress(img, quality=quality, backend=backend, device=device)
    t1 = time.perf_counter()
    out = api.decompress(data, backend=backend, device=device)
    t2 = time.perf_counter()
    return data, out, t1 - t0, t2 - t1


def load_corpus(directory: str | None = None, limit: int | None = None):
    """(N, H, W) uint8: ``directory``'s numbered GIFs, or synthetic."""
    import numpy as np

    from .. import corpus

    n = 49 if limit is None else min(limit, 49)
    if directory is None:
        return corpus.synthetic_corpus(n)
    from PIL import Image

    return np.stack([
        np.asarray(Image.open(os.path.join(directory, f"{i}.gif"))
                   .convert("L"))
        for i in range(1, n + 1)
    ])


def run_corpus(backend: str, out_csv: str, limit: int | None = None,
               device=None, directory: str | None = None):
    import numpy as np

    from .. import api, metrics

    images = load_corpus(directory, limit)
    rows = []
    for i, img in enumerate(images):
        for q in QUALITIES:
            data, out, t_c, t_d = _roundtrip(api, img, q, backend, device)
            rows.append({
                "image": i + 1,
                "quality": q,
                "ratio": round(metrics.compression_ratio(img, data), 4),
                "psnr_ref_formula": round(
                    metrics.psnr_reference(img, out), 4),
                "psnr": round(metrics.psnr(img, out), 4),
                "compress_time": round(t_c, 6),
                "decompress_time": round(t_d, 6),
            })
        print(f"image {i + 1}/{len(images)}", file=sys.stderr)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    ratio = np.mean([r["ratio"] for r in rows if r["quality"] == 50])
    psnr = np.mean([r["psnr"] for r in rows if r["quality"] == 50])
    print(f"q=50 mean ratio {ratio:.2f}:1, mean PSNR {psnr:.2f} dB")
    return rows


def run_figure(backend: str, out_png: str, device=None,
               directory: str | None = None):
    """3 corpus images x 6 qualities -> 4-panel bar chart."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from .. import api, metrics

    images = load_corpus(directory, 3)
    names = [f"image {i + 1}" for i in range(len(images))]
    stats = {k: {n: [] for n in names}
             for k in ("ratio", "psnr", "ctime", "dtime")}
    for name, img in zip(names, images):
        for q in FIGURE_QUALITIES:
            data, out, t_c, t_d = _roundtrip(api, img, q, backend, device)
            stats["ratio"][name].append(metrics.compression_ratio(img, data))
            stats["psnr"][name].append(metrics.psnr_reference(img, out))
            stats["ctime"][name].append(t_c)
            stats["dtime"][name].append(t_d)

    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    panels = [
        ("ratio", "Compression Ratio"),
        ("psnr", "PSNR (dB, reference formula)"),
        ("ctime", "Compress Time (s)"),
        ("dtime", "Decompress Time (s)"),
    ]
    x = np.arange(len(FIGURE_QUALITIES))
    width = 0.25
    for ax, (key, title) in zip(axes.flat, panels):
        for j, name in enumerate(names):
            ax.bar(x + (j - 1) * width, stats[key][name], width, label=name)
        ax.set_xticks(x)
        ax.set_xticklabels([str(q) for q in FIGURE_QUALITIES])
        ax.set_xlabel("quality")
        ax.set_title(title)
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    print(out_png)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Corpus benchmark harness.")
    p.add_argument("--backend", choices=["auto", "torch", "host"],
                   default="auto")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--corpus", default=None, metavar="DIR",
                   help="directory of the numbered corpus GIFs")
    p.add_argument("--csv", default="benchmark_results.csv")
    p.add_argument("--figure", default=None, metavar="PNG")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    run_corpus(args.backend, args.csv, args.limit, args.device, args.corpus)
    if args.figure:
        run_figure(args.backend, args.figure, args.device, args.corpus)
    return 0


if __name__ == "__main__":
    sys.exit(main())

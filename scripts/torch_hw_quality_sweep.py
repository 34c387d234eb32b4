#!/usr/bin/env python3
"""Quality sweep of the PyTorch/CUDA port on the card
-> reports/torch_hw_quality_sweep.json.

The counterpart of ``scripts/hw_quality_sweep.py``: the exact path
(``exact_transform`` on the card, the float64 recompute of flagged blocks,
``encode2`` + ``place``) on Lenna at q 10, 25, 50, 75 and 90, then on the
49-image corpus at q=50, each stream checked byte for byte against the
float64 host oracle (``container.compress(..., block_index=True)``), with
its compression ratio and PSNR beside the oracle's own
(``tinyimgcodec_tpu_torch/conformance.py``, :func:`quality_sweep`).

Lenna and the corpus are read from ``corpus.REFERENCE_DATA`` (``data/`` in
the checkout) when it is there; otherwise ``corpus.synthetic_corpus`` stands in, and the report
names the image it really used.  The reference's published corpus means
(``BASELINE.md``) are set beside the corpus row only for the real corpus.

Usage:
    python3 scripts/torch_hw_quality_sweep.py [--skip-corpus]
        [--device cpu] [--out PATH]

Without ``--device`` it needs the card and raises without one;
``--device cpu`` runs the plain versions.  The last line of its output is
``{"all_byte_identical": ...}``; the exit code is 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tinyimgcodec_tpu_torch import conformance, corpus  # noqa: E402
from tinyimgcodec_tpu_torch.device import (  # noqa: E402
    card_info, resolve_device,
)

# BASELINE.md: the reference's corpus means at q=50 (no block index)
BASELINE_MEAN_CR = 9.12
BASELINE_MEAN_PSNR = 31.97


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--skip-corpus", action="store_true")
    p.add_argument("--device", default=None,
                   help="cpu for the plain versions (default: the card)")
    p.add_argument("--out", default=str(REPO / "reports"
                                        / "torch_hw_quality_sweep.json"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    real = corpus.corpus_available()
    name = "lenna" if real else "synthetic_corpus[0]"
    rows = conformance.quality_sweep(
        [corpus.load_named("Lenna")], conformance.SWEEP_QUALITIES, dev,
        names=[name])
    for r in rows:
        print(r, file=sys.stderr, flush=True)
    report: dict = {
        "card": card_info() if dev.type == "cuda" else "cpu (plain versions)",
        "device": str(dev),
        "rows": rows,
    }
    all_identical = all(r["byte_identical_to_host_oracle"] for r in rows)

    if not args.skip_corpus:
        images = corpus.load_corpus()
        crows = conformance.quality_sweep(images, (50,), dev)
        ident = sum(r["byte_identical_to_host_oracle"] for r in crows)
        mean = lambda k: float(np.mean([r[k] for r in crows]))  # noqa: E731
        report["corpus"] = {
            "images": len(crows),
            "source": ("the reference corpus, 1.gif..49.gif" if real
                       else f"synthetic_corpus({len(crows)})"),
            "byte_identical": ident,
            "corpus_q50_mean_cr": mean("cr"),
            "corpus_q50_mean_cr_no_index": mean("cr_no_index"),
            "corpus_q50_mean_psnr": mean("psnr"),
            "oracle_q50_mean_cr": mean("oracle_cr"),
            "oracle_q50_mean_psnr": mean("oracle_psnr"),
        }
        if real:
            report["corpus"].update(baseline_mean_cr=BASELINE_MEAN_CR,
                                    baseline_mean_psnr=BASELINE_MEAN_PSNR)
        all_identical = all_identical and ident == len(crows)
        print(report["corpus"], file=sys.stderr, flush=True)

    report["note"] = (
        "exact path of the port (exact_transform, the float64 recompute of "
        "flagged blocks, encode2 + place) with the block index; bytes "
        "checked against the float64 host oracle container.compress(..., "
        "block_index=True); cr with the index, cr_no_index without it (the "
        "reference's layout); first_call_s holds the kernels' load in the "
        "first row; host clock, synchronised")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"all_byte_identical": bool(all_identical)}))
    return 0 if all_identical else 1


if __name__ == "__main__":
    sys.exit(main())

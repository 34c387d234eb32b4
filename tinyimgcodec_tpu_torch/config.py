"""Codec configuration (SURVEY 5 "config/flag system" equivalent).

The reference's three knobs (quality int, auto table bool, C qfactor enum,
reference utils.py:50 / codec.py:133 / c/encode.c:19-34) generalize to a
dataclass carried through the pipeline; the persisted wire state remains
the 16-byte header (docs/FORMAT.md).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """End-to-end encode/decode configuration."""

    quality: int = 50           # 1..99 (reference scale mapping)
    precision: str = "exact"    # "exact" (reference-bit-identical) | "fast"
    auto_huffman_table: bool = False  # embed frequency-optimal tables
    block_index: bool | None = None  # append the TICX parallel-decode
    #                             trailer.  None (the default) resolves
    #                             to ON: the device entropy decoder
    #                             needs it, it costs ~1.3% at stride 64,
    #                             and reference decoders ignore it
    #                             (docs/FORMAT.md).  Dynamic-table
    #                             streams carry the same payload-
    #                             relative trailer.
    index_stride: int = 64      # blocks per TICX chunk (power of two);
    #                             smaller = more decode parallelism,
    #                             ~4*nb/stride trailer bytes per image
    assemble: str = "host"      # "host" (byte-conformant) | "device"
    bits_per_pixel_budget: float = 6.0  # device-assembly buffer sizing
    mesh_devices: int | None = None     # None = all local devices
    tile_blocks: int = 512      # pallas kernel tile size

    def __post_init__(self):
        if not 1 <= self.quality <= 99:
            raise ValueError(
                f"quality must be in 1..99, got {self.quality} "
                "(100 would make the IJG scale factor zero; the reference "
                "NaNs there, SURVEY quirk 2.5-6)"
            )
        if self.precision not in ("exact", "fast"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.assemble not in ("host", "device"):
            raise ValueError(f"unknown assemble mode {self.assemble!r}")
        if (
            self.index_stride < 1
            or self.index_stride & (self.index_stride - 1)
        ):
            raise ValueError(
                f"index_stride must be a power of two, got "
                f"{self.index_stride}"
            )
        if self.index_stride > 4096:
            # the device decoder's worst-case rerun allocates
            # stride * 68 slot rows per chunk; an unbounded stride would
            # trade a clean fallback for a device OOM
            raise ValueError(
                f"index_stride must be <= 4096, got {self.index_stride}"
            )
        if self.block_index is None:
            object.__setattr__(self, "block_index", True)


# The embedded encoder's qfactor enum (reference c/img.h:22).
QFACTOR_BEST = 0
QFACTOR_HIGH = 1
QFACTOR_MED = 2
QFACTOR_LOW = 3
QFACTOR_NAMES = {
    "best": QFACTOR_BEST,
    "high": QFACTOR_HIGH,
    "med": QFACTOR_MED,
    "low": QFACTOR_LOW,
}

"""Engine configuration (the reference hardcodes these as constants —
src/main.cpp:7 chunk_size, column_reader.cpp:34 header window,
parquet_writer.hpp:35 page size; here they are one dataclass + env overrides).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


@dataclass
class EngineConfig:
    # format / layout
    index_chunk_size: int = 4096       # reference: src/main.cpp:7
    writer_page_bytes: int = 1024      # reference: parquet_writer.hpp:35
    batch_align: int = 128             # device trailing-dim padding
    string_pitch_align: int = 8        # char-matrix pitch rounding

    # scan
    scan_engine: str = "jax"           # "jax" | "numpy"
    max_dfa_states: int = 4096
    pair_step: bool = False            # 2-bytes-per-step composed matcher in
                                       # the lax.scan walk (DPQ_PAIR_STEP=1);
                                       # not measured on the H100

    # parallel
    pages_per_shard_multiple: int = 8
    exchange_capacity_slack: float = 1.0
    exchange_mode: str = "ragged"      # "ragged": exact-size
                                       # jax.lax.ragged_all_to_all (emulated
                                       # on backends without the HLO — CPU);
                                       # "padded": dense [D, D, cap] buckets
                                       # (DPQ_EXCHANGE_MODE overrides)

    # observability
    emit_metrics: bool = True
    profile_dir: str | None = None     # jax.profiler trace output

    @classmethod
    def from_env(cls, prefix: str = "DPQ_") -> "EngineConfig":
        cfg = cls()
        for f in fields(cls):
            key = prefix + f.name.upper()
            if key not in os.environ:
                continue
            raw = os.environ[key]
            t = f.type if isinstance(f.type, type) else type(getattr(cfg, f.name) or "")
            if t is bool or isinstance(getattr(cfg, f.name), bool):
                setattr(cfg, f.name, raw.lower() in ("1", "true", "yes"))
            elif isinstance(getattr(cfg, f.name), int):
                setattr(cfg, f.name, int(raw))
            elif isinstance(getattr(cfg, f.name), float):
                setattr(cfg, f.name, float(raw))
            else:
                setattr(cfg, f.name, raw)
        return cfg


_default: EngineConfig | None = None


def get_config() -> EngineConfig:
    global _default
    if _default is None:
        _default = EngineConfig.from_env()
    return _default


def set_config(cfg: EngineConfig | None) -> None:
    """Installs `cfg` as the process default (None re-reads the env on next
    get_config) — tests and embedding applications use this."""
    global _default
    _default = cfg

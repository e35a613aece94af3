"""duckdb_parquet_parser — a vectorized Parquet scan engine on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`sputnik89/duckdb-parquet-parser`: host-side (C++17) Thrift footer/metadata
parsing, page indexing and structural pre-scan; device-side branch-free page
decode (PLAIN / RLE-dictionary / definition-level null materialization), regex
(LIKE / NOT LIKE) page-pruning scans, and chunked inverted-index construction
— scaling over device meshes via `jax.sharding` + `shard_map`.
"""

from .version import __version__

__all__ = [
    "__version__",
    # lazily-resolved public surface (heavy deps load on first touch)
    "ParquetReader", "ParquetWriter", "ColumnSpec", "DecodedColumn",
    "ScanEngine", "ResidentColumn", "cold_scan",
    "EngineConfig", "get_config", "set_config",
]

_LAZY = {
    "ParquetReader": ("duckdb_parquet_parser.host.reader", "ParquetReader"),
    "DecodedColumn": ("duckdb_parquet_parser.host.reader", "DecodedColumn"),
    "ParquetWriter": ("duckdb_parquet_parser.host.writer", "ParquetWriter"),
    "ColumnSpec": ("duckdb_parquet_parser.host.writer", "ColumnSpec"),
    "ScanEngine": ("duckdb_parquet_parser.models.scan", "ScanEngine"),
    "ResidentColumn": ("duckdb_parquet_parser.models.scan", "ResidentColumn"),
    "cold_scan": ("duckdb_parquet_parser.models.scan", "cold_scan"),
    "EngineConfig": ("duckdb_parquet_parser.utils.config", "EngineConfig"),
    "get_config": ("duckdb_parquet_parser.utils.config", "get_config"),
    "set_config": ("duckdb_parquet_parser.utils.config", "set_config"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Fixture generation helpers: varied Parquet files via the native writer."""

from __future__ import annotations

import numpy as np

from duckdb_parquet_parser.host.schema import ParquetType
from duckdb_parquet_parser.host.writer import ColumnSpec, ParquetWriter

WORDS = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel",
    "india", "juliet", "kilo", "lima", "mike", "november", "oscar", "papa",
]


def random_strings(rng, n, *, n_unique=None, null_p=0.0, min_len=3, max_len=30):
    """Returns (values list[bytes|None]).  n_unique small => dict-encoded."""
    if n_unique is not None:
        pool = [
            ("%s_%s_%d" % (rng.choice(WORDS), rng.choice(WORDS), i)).encode()
            for i in range(n_unique)
        ]
        vals = [pool[int(rng.integers(len(pool)))] for _ in range(n)]
    else:
        letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
        vals = []
        for _ in range(n):
            ln = int(rng.integers(min_len, max_len + 1))
            vals.append(bytes(rng.choice(letters, ln)))
    if null_p > 0:
        vals = [None if rng.random() < null_p else v for v in vals]
    return vals


def mixed_file(path, rng, *, rows_per_rg=(700, 500), null_p=0.12) -> str:
    """The kitchen-sink fixture: every writer-supported type, optional and
    required, dict and plain, several row groups."""
    specs = [
        ColumnSpec("i64", ParquetType.INT64),
        ColumnSpec("i64_opt", ParquetType.INT64, optional=True),
        ColumnSpec("i32", ParquetType.INT32, optional=True),
        ColumnSpec("f32", ParquetType.FLOAT, optional=True),
        ColumnSpec("f64", ParquetType.DOUBLE),
        ColumnSpec("flag", ParquetType.BOOLEAN, optional=True),
        ColumnSpec("city", ParquetType.BYTE_ARRAY, optional=True),   # dict
        ColumnSpec("comment", ParquetType.BYTE_ARRAY, optional=True),  # plain
        ColumnSpec("code", ParquetType.INT32),                       # dict ints
    ]
    w = ParquetWriter(path, specs)
    for n in rows_per_rg:
        valid = (rng.random(n) > null_p).astype(np.uint8)
        w.write_row_group(
            {
                "i64": rng.integers(-(2**62), 2**62, n),
                "i64_opt": (rng.integers(-(2**62), 2**62, n), valid),
                "i32": (rng.integers(-(2**31), 2**31, n).astype(np.int32), valid),
                "f32": (rng.random(n).astype(np.float32), valid),
                "f64": rng.standard_normal(n),
                "flag": (rng.random(n) > 0.5, valid),
                "city": random_strings(rng, n, n_unique=9, null_p=null_p),
                "comment": random_strings(rng, n, null_p=null_p),
                "code": np.asarray(rng.choice([7, 11, 13, 17], n), np.int32),
            }
        )
    w.close()
    return str(path)


def strings_file(path, rng, *, n=1500, n_unique=None, null_p=0.1, rgs=2) -> str:
    # The footer pad keeps files inside the reference's envelope: its 256-byte
    # page-header probes poison the ifstream (failbit never cleared) when they
    # cross EOF, which happens whenever last-page + footer < 256 bytes.
    specs = [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)]
    w = ParquetWriter(path, specs, key_value={"pad": "x" * 512})
    for _ in range(rgs):
        w.write_row_group({"s": random_strings(rng, n, n_unique=n_unique, null_p=null_p)})
    w.close()
    return str(path)

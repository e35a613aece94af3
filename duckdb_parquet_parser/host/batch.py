"""DecodeBatch — the host→device hand-off unit produced by the pre-scan.

Wraps the SoA arrays of native/dpq_prescan.hpp with typed views (int32 value
planes) and slicing, so the scan pipeline can shard pages across devices by
simple array slicing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from ..ops import decode as _decode
from .schema import ParquetType

_PER_PAGE_ARRAYS = [
    "page_num_values", "page_nn", "page_kind", "page_def_bw", "page_idx_bw",
    "page_def_nruns", "page_idx_nruns", "page_row_start", "page_gid",
    "page_rg", "page_dict_base", "page_dict_size",
    "def_run_kind", "def_run_count", "def_run_value", "def_run_bitoff",
    "def_run_vstart", "idx_run_kind", "idx_run_count", "idx_run_value",
    "idx_run_bitoff", "idx_run_vstart",
    "def_bytes", "idx_bytes", "plain_fixed", "bool_bits",
    "payload", "page_payload_len",
    "def_levels", "idx_vals",
]

_NUMPY_DTYPES = {
    ParquetType.INT32: np.dtype("<i4"),
    ParquetType.INT64: np.dtype("<i8"),
    ParquetType.FLOAT: np.dtype("<f4"),
    ParquetType.DOUBLE: np.dtype("<f8"),
}


@dataclass
class DecodeBatch:
    dims: dict
    arrays: dict = field(repr=False)

    @property
    def n_pages(self) -> int:
        return int(self.dims["n_pages"])

    @property
    def type(self) -> ParquetType:
        return ParquetType(self.dims["type"])

    @property
    def max_def(self) -> int:
        return int(self.dims["max_def"])

    @property
    def vmax(self) -> int:
        return int(self.dims["vmax"])

    @property
    def nn_cap(self) -> int:
        return int(self.dims["nn_cap"])

    @property
    def total_rows(self) -> int:
        return int(self.arrays["page_num_values"].sum())

    @property
    def value_dtype(self) -> np.dtype | None:
        return _NUMPY_DTYPES.get(self.type)

    @cached_property
    def mode(self) -> str:
        """Static decode specialization: 'plain' | 'dict' | 'mixed'."""
        kinds = np.unique(self.arrays["page_kind"])
        if kinds.size <= 1:
            return "dict" if (kinds.size and kinds[0] == 1) else "plain"
        return "mixed"

    @cached_property
    def plain_planes(self) -> list[np.ndarray]:
        w = int(self.dims["plain_w"])
        if w == 0 or "plain_fixed" not in self.arrays:
            return []
        return _decode.fixed_planes_from_bytes(self.arrays["plain_fixed"], w)

    @cached_property
    def dict_planes(self) -> list[np.ndarray]:
        if "dict_fixed" not in self.arrays:
            return []
        w = self.arrays["dict_fixed"].shape[1]
        return _decode.dict_planes_from_bytes(self.arrays["dict_fixed"], int(w))

    @cached_property
    def dict_planes_pp(self) -> list[np.ndarray]:
        """Per-page LOCAL dictionary tables: [N, dn_max] i32 per plane
        (plane[base[p] + d] for d < dict_size[p], zero beyond).  Built once
        on host — lets the device select on the in-page index (dn_max ops)
        instead of the concatenated global table (sum of chunk sizes);
        see ops/dict_lookup.dict_lookup_local.

        Returns [] when dn_max exceeds SELECT_DICT_MAX — the device gate in
        ops/decode._lookup_values would ignore the tables anyway, and for a
        large dictionary the [N, dn_max] planes are pure dead weight (host
        memory + transfer)."""
        planes = self.dict_planes
        if not planes:
            return []
        from ..ops.dict_lookup import SELECT_DICT_MAX

        base = np.asarray(self.arrays["page_dict_base"], np.int64)
        size = np.asarray(self.arrays["page_dict_size"], np.int64)
        dn_max = int(size.max()) if size.size else 0
        if dn_max > SELECT_DICT_MAX:
            return []
        dn = planes[0].shape[0]
        out = []
        idx = base[:, None] + np.arange(max(dn_max, 1))[None, :]
        valid = np.arange(max(dn_max, 1))[None, :] < size[:, None]
        idx = np.clip(idx, 0, max(dn - 1, 0))
        for p in planes:
            out.append(np.where(valid, np.asarray(p)[idx], 0).astype(np.int32))
        return out

    @property
    def bool_bits(self) -> np.ndarray | None:
        return self.arrays.get("bool_bits")

    def slice_pages(self, lo: int, hi: int) -> "DecodeBatch":
        """A view batch over pages [lo, hi) (string globals kept whole)."""
        dims = dict(self.dims)
        dims["n_pages"] = hi - lo
        arrays = dict(self.arrays)
        for name in _PER_PAGE_ARRAYS:
            if name in arrays:
                arrays[name] = arrays[name][lo:hi]
        if "str_nn_start" in arrays:
            arrays["str_nn_start"] = arrays["str_nn_start"][lo : hi + 1]
        return DecodeBatch(dims, arrays)

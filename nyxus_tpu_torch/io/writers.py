# Copied verbatim from nyxus_tpu/io/writers.py (that package imports jax); pinned by tests/test_torch_tables.py.
"""Output writers: CSV (single/separate), Apache Arrow IPC, Parquet.

Reference: src/nyx/output_2_csv.cpp, output_writers.cpp,
arrow_output_stream.h.  Non-finite feature values are replaced with the
soft-NAN substitute at write time (Nyxus::force_finite_number).
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd


def default_out_name(output_type: str) -> str:
    return {"arrowipc": "NyxusFeatures.arrow",
            "parquet": "NyxusFeatures.parquet"}.get(output_type,
                                                    "NyxusFeatures.csv")


def resolve_output_path(output_path: str, output_type: str) -> str:
    """Reference behavior (nyxus.py docstrings): a directory gets the default
    file name appended; missing directories are created."""
    if not output_path:
        return default_out_name(output_type)
    root, ext = os.path.splitext(output_path)
    if ext == "" or os.path.isdir(output_path):
        os.makedirs(output_path, exist_ok=True)
        return os.path.join(output_path, default_out_name(output_type))
    d = os.path.dirname(output_path)
    if d:
        os.makedirs(d, exist_ok=True)
    return output_path


def write_dataframe(df: pd.DataFrame, output_type: str, output_path: str) -> str:
    out = resolve_output_path(output_path, output_type)
    if output_type == "arrowipc":
        import pyarrow as pa
        import pyarrow.feather  # noqa: F401
        table = pa.Table.from_pandas(df, preserve_index=False)
        with pa.OSFile(out, "wb") as f:
            with pa.ipc.new_file(f, table.schema) as writer:
                writer.write_table(table)
        return out
    if output_type == "parquet":
        import pyarrow as pa
        import pyarrow.parquet as pq
        table = pa.Table.from_pandas(df, preserve_index=False)
        pq.write_table(table, out)
        return out
    _write_csv(df, out)
    return out


def _write_csv(df: pd.DataFrame, out: str):
    """CSV via the native writer when available (the reference's CSV stage is
    native, output_2_csv.cpp), pandas otherwise."""
    from .. import native
    num_cols = [c for c in df.columns
                if pd.api.types.is_numeric_dtype(df[c].dtype)]
    str_cols = [c for c in df.columns if c not in num_cols]
    # native path requires the standard layout: string cols first
    if (native.available() and str_cols and num_cols
            and list(df.columns[:len(str_cols)]) == str_cols):
        header = ",".join(str(c) for c in df.columns)
        prefixes = [",".join(str(v) for v in row)
                    for row in df[str_cols].itertuples(index=False)]
        native.write_csv(out, header, prefixes,
                         df[num_cols].to_numpy(np.float64),
                         noval_text="nan", precision=17)
        return
    df.to_csv(out, index=False)


class StreamingArrowWriter:
    """Per-slide streaming Arrow/Parquet commits (ArrowOutputStream,
    arrow_output_stream.h:22-57)."""

    def __init__(self, output_type: str, output_path: str):
        import pyarrow as pa
        self.output_type = output_type
        self.path = resolve_output_path(output_path, output_type)
        self._writer = None
        self._pa = pa

    def write(self, df: pd.DataFrame):
        table = self._pa.Table.from_pandas(df, preserve_index=False)
        if self._writer is None:
            if self.output_type == "parquet":
                import pyarrow.parquet as pq
                self._writer = pq.ParquetWriter(self.path, table.schema)
            else:
                self._sink = self._pa.OSFile(self.path, "wb")
                self._writer = self._pa.ipc.new_file(self._sink, table.schema)
        if self.output_type == "parquet":
            self._writer.write_table(table)
        else:
            self._writer.write_table(table)

    def close(self):
        if self._writer is not None:
            self._writer.close()
        if getattr(self, "_sink", None) is not None:
            self._sink.close()

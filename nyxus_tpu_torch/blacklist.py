# Copied verbatim from nyxus_tpu/blacklist.py (that package imports jax); pinned by tests/test_torch_tables.py.
"""ROI blacklist (reference: src/nyx/roi_blacklist.{h,cpp}).

Grammar: a global comma-separated label list ("27,28,30") or per-file lists
("file1.tif:5,6;file2.tif:1,2").  Blacklisted ROIs keep their output row with
blank (unassigned) feature values.
"""

from __future__ import annotations


class RoiBlacklist:
    def __init__(self):
        self.clear()

    def clear(self):
        self.defined = False
        self.global_list = []
        self.file_lists = []  # [(fname, [labels])]

    def parse_raw_string(self, raw: str):
        if not raw:
            raise ValueError("empty blacklist string")
        if ":" in raw:
            parts = raw.split(";") if ";" in raw else [raw]
            for p in parts:
                if ":" not in p:
                    raise ValueError("Error: in %s expecting ':'" % p)
                lhs, rhs = p.split(":", 1)
                if any(c.isspace() for c in lhs):
                    raise ValueError("Error: %s contains a space character" % lhs)
                labels = [int(s) for s in rhs.split(",") if s]
                self.file_lists.append((lhs, labels))
        else:
            self.global_list = [int(s) for s in raw.split(",") if s]
        self.defined = True

    def check(self, fname: str, label: int) -> bool:
        if not self.defined:
            return False
        if self.global_list:
            return label in self.global_list
        for f, labels in self.file_lists:
            if f == fname:
                return label in labels
        return False

    def summary(self) -> str:
        if not self.defined:
            return "blacklist is not defined"
        lines = []
        if self.global_list:
            lines.append("global blacklist: " +
                         ",".join(str(v) for v in self.global_list))
        for f, labels in self.file_lists:
            lines.append("%s: %s" % (f, ",".join(str(v) for v in labels)))
        return "\n".join(lines)

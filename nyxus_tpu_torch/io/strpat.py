# Copied verbatim from nyxus_tpu/io/strpat.py; pinned by tests/test_torch_tables.py.
"""Polus-style filepattern for 3D layout-A z-stacks.

The reference tokenizes patterns like ``BRATS_{d+}_z{set d+}_t{d+}.ome.tif``
into a TEXT/NUM/SEP grammar and mines the ``{set d+}`` position as the
z-index of each slice file (reference: src/nyx/strpat.h:6-57, strpat.cpp).
Here the same grammar compiles to one regex with a capture group at the
z-set position; files that share everything but the z value form one volume.
"""

from __future__ import annotations

import re


class StringPattern:
    """Layout-A filepattern: {d+} digit run, {c+} alpha run, {set d+} (or
    {set,d+}) the z-index capture; everything else matches literally."""

    _SET = ("{set d+}", "{set,d+}")

    def __init__(self, pattern: str = ""):
        self.pattern = pattern
        self._re = None
        self.ermsg = ""
        if pattern:
            self.set_filepattern(pattern)

    @staticmethod
    def is_layoutA_fpattern(p: str) -> bool:
        return "set d+" in p or "set,d+" in p

    @property
    def is_25d(self) -> bool:
        return self.is_layoutA_fpattern(self.pattern)

    def set_filepattern(self, pat: str) -> bool:
        self.pattern = pat
        out = []
        i = 0
        n_sets = 0
        while i < len(pat):
            if pat.startswith(("{set d+}", "{set,d+}"), i):
                out.append(r"(\d+)")
                n_sets += 1
                i += len("{set d+}")
            elif pat.startswith("{d+}", i):
                out.append(r"\d+")
                i += 4
            elif pat.startswith("{c+}", i):
                out.append(r"[a-zA-Z]+")
                i += 4
            elif pat[i] == "{":
                self.ermsg = ("illegal {Expression}. Only {d+}, {c+}, and "
                              "{set d+} or {set,d+} are permitted")
                return False
            else:
                out.append(re.escape(pat[i]))
                i += 1
        if n_sets > 1:
            self.ermsg = "only one {set d+} term is permitted"
            return False
        try:
            self._re = re.compile("^" + "".join(out) + "$")
        except re.error as e:
            self.ermsg = str(e)
            return False
        return True

    def good(self) -> bool:
        return self._re is not None

    def match(self, fname: str):
        """(group_key, z_value) for a matching filename, else None.  The
        group key is the filename with the z digits replaced by '*' -- the
        reference's imgDirs aggregation key (strpat.cpp:225-260)."""
        if self._re is None:
            return None
        m = self._re.match(fname)
        if not m:
            return None
        if m.re.groups == 0:
            return fname, ""
        key = fname[:m.start(1)] + "*" + fname[m.end(1):]
        return key, m.group(1)


def group_zstack(fnames, pattern: StringPattern):
    """{volume_key_with_star: sorted [z_values]} over matching filenames."""
    vols = {}
    for f in fnames:
        hit = pattern.match(f)
        if hit is None:
            continue
        key, z = hit
        vols.setdefault(key, []).append(z)
    for key in vols:
        vols[key].sort(key=lambda z: int(z) if z.isdigit() else z)
    return vols

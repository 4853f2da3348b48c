# Copied verbatim from nyxus_tpu/metaparams.py (that package imports jax); pinned by tests/test_torch_tables.py.
"""Path-addressed runtime metaparameters.

The reference exposes feature-family settings slots through a small
``<family>/<param>=<value>`` grammar (reference: src/nyx/env_metaparams.cpp:63-382,
bindings new_bindings_py.cpp:1102-1103).  Here the same grammar reads/writes
fields of the frozen ``EngineConfig``; setting returns a *new* config (the
engine recompiles on the next run, which is how jitted kernels pick up the
change).

Path inventory (env_metaparams.cpp):
  glcm/greydepth  glcm/offset
  3glcm/greydepth 3glcm/offset 3glcm/numang 3glcm/sparseintensities
  3gldm/greydepth
  3ngtdm/greydepth 3ngtdm/radius
  3glrlm/greydepth
  3glszm/greydepth (the reference setter also matches the truncated "3glsz"
  spelling, env_metaparams.cpp:362 — both are accepted here)

Note: the reference registers D3_GLRLM's settings vector under
D3_GLSZM_feature's typeid (env_features.cpp:700-702), so its ``3glrlm/*``
slot is written but never read by the calculator.  We implement the intended
behavior instead: ``3glrlm/greydepth`` really controls 3D GLRLM.
"""

from __future__ import annotations

from .config import EngineConfig


def _parse_int(s: str):
    try:
        return int(s, 0)
    except ValueError:
        return None


def _parse_positive_int(s: str):
    v = _parse_int(s)
    return v if v is not None and v > 0 else None


# path -> (config field, value parser, fallback field for reads)
_PARAMS = {
    ("glcm", "greydepth"): ("glcm_greydepth", _parse_int, "coarse_gray_depth"),
    ("glcm", "offset"): ("glcm_offset", _parse_int, None),
    ("3glcm", "greydepth"): ("d3_glcm_greydepth", _parse_int, "coarse_gray_depth"),
    ("3glcm", "offset"): ("d3_glcm_offset", _parse_int, "glcm_offset"),
    ("3glcm", "numang"): ("d3_glcm_numang", _parse_int, None),
    ("3glcm", "sparseintensities"): ("d3_glcm_sparseintensities", _parse_int, None),
    ("3gldm", "greydepth"): ("d3_gldm_greydepth", _parse_int, "coarse_gray_depth"),
    ("3ngtdm", "greydepth"): ("d3_ngtdm_greydepth", _parse_int, "coarse_gray_depth"),
    ("3ngtdm", "radius"): ("d3_ngtdm_radius", _parse_positive_int, None),
    ("3glrlm", "greydepth"): ("d3_glrlm_greydepth", _parse_int, "coarse_gray_depth"),
    ("3glszm", "greydepth"): ("d3_glszm_greydepth", _parse_int, "coarse_gray_depth"),
    ("3glsz", "greydepth"): ("d3_glszm_greydepth", _parse_int, "coarse_gray_depth"),
}


def _split_path(name: str):
    ppath = name.split("/")
    if len(ppath) not in (1, 2):
        return None
    return tuple(ppath)


def set_metaparam(cfg: EngineConfig, p_val: str):
    """Returns (new_cfg, error_string_or_None)."""
    eq_sides = p_val.split("=")
    if len(eq_sides) != 2:
        return cfg, ('syntax error in "%s": expecting <paramName>=<paramVal>'
                     % p_val)
    ppath = _split_path(eq_sides[0])
    if ppath is None:
        return cfg, ('syntax error in <paramName>=<paramVal> of "%s": '
                     "expecting <paramName> to be <feature name>/<parameter "
                     "name> or <common parameter name>" % p_val)
    if len(ppath) == 1:
        return cfg, 'error: unrecognized parameter "%s"' % ppath[0]
    entry = _PARAMS.get(ppath)
    if entry is None:
        known_fams = {f for f, _ in _PARAMS}
        if ppath[0] in known_fams:
            return cfg, ('error: unrecognized feature parameter of feature '
                         '%s: "%s"' % (ppath[0], ppath[1]))
        return cfg, 'error: unrecognized feature "%s"' % ppath[0]
    field, parser, _ = entry
    v = parser(eq_sides[1])
    if v is None:
        return cfg, ('error: cannot parse value "%s" of %s/%s: expecting an '
                     "integer" % (eq_sides[1], ppath[0], ppath[1]))
    return cfg.replace(**{field: v}), None


def get_metaparam(cfg: EngineConfig, p_name: str):
    """Returns (value, error_string).  Error is "" on success; the returned
    value is the *effective* one (fallback-resolved), matching the compiled
    settings slot the reference reads back."""
    ppath = _split_path(p_name)
    if ppath is None or len(ppath) == 1:
        return 0.0, ('syntax error in "%s": expecting <feature name>/'
                     "<parameter name>" % p_name)
    entry = _PARAMS.get(ppath)
    if entry is None:
        return 0.0, 'error: unrecognized parameter "%s"' % p_name
    field, _, fallback = entry
    v = getattr(cfg, field)
    if v is None and fallback is not None:
        v = getattr(cfg, fallback)
    return float(v if v is not None else 0), ""

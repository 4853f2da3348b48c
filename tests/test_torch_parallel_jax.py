"""The port's scale-out (``nyxus_tpu_torch.parallel``) against the JAX
package's (``nyxus_tpu.parallel``), in f64 on the CPU.

Over cards: ``Nyxus(n_devices=k)`` splits each ROI bucket into k shards
(on the CPU, k shards of the one CPU device, as the JAX tests force 8
host devices).  After tests/test_parallel.py: its request ``FEATS``, held
against the port at one device at rtol 1e-12 (``test_mesh_parity_8dev``'s
tolerance) and against JAX's ``n_devices=k`` run at rtol 1e-9 (5e-7 for
the fast_log2 entropies, NaN alike), in memory, with fewer ROIs than
shards (3 ROIs on 8), tile-streamed (``ram_limit=1``) and in 3D (JAX's
sharded 3D run in a subprocess, as tests/test_parallel.py runs it).  The
helpers: ``roi_devices`` against ``roi_mesh``, ``shard_batch``'s partition
against JAX's less its pad rows, ``process_shard`` against JAX's.

Over processes: two port processes run ``featurize_directory(
shard_slides=True)``, placed by ``NYXUS_PROCESS_INDEX`` /
``NYXUS_PROCESS_COUNT`` or joined by ``initialize_distributed`` (gloo over
tcp://localhost); every pair lands in exactly one shard, the union equals
the one-process run, and each shard's rows equal JAX's rows of the same
shard."""

import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from conftest import make_blobs, make_blobs3d

import nyxus_tpu
from nyxus_tpu import parallel as jpar

import nyxus_tpu_torch
from nyxus_tpu_torch import parallel as tpar
from nyxus_tpu_torch.io.tiff import write_tiff
from nyxus_tpu_torch.pipeline import runner as trunner

from test_torch_slice import _compare_all
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATS = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*BASIC_MORPHOLOGY*",
         "*ALL_NGTDM*", "PERIMETER", "SOLIDITY"]
FEATS_3D = ["*3D_ALL_INTENSITY*", "*3D_GLCM*"]
SHARD_FEATS = ["MEAN", "AREA_PIXELS_COUNT", "PERIMETER"]
CPU = torch.device("cpu")


def _vals(df):
    return df[df.columns[4:]].to_numpy(float)


def _same_frames(got, want):
    """JAX's and the port's frames: the same rows and columns, the values
    within the JAX tolerances."""
    assert list(got.columns) == list(want.columns)
    for c in got.columns[:4]:
        assert list(got[c]) == list(want[c]), c
    _compare_all(list(got.columns[4:]), _vals(want), _vals(got))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """case -> (input, shard count): tests/test_parallel.py's blob pair on
    8 shards, its 3-ROI slide on 8, and a 200 x 200 TIFF pair (over the
    RAM gate at ram_limit=1, so it streams) on 4."""
    root = tmp_path_factory.mktemp("parallel")
    si, sl = make_blobs(200, 200, 12, seed=5)
    ip, lp = str(root / "i.tif"), str(root / "l.tif")
    write_tiff(ip, si.astype(np.uint16), tile_size=64)
    write_tiff(lp, sl.astype(np.uint16))
    return {"in-memory": (make_blobs(), 8),
            "3 ROIs on 8 shards": (make_blobs(h=96, w=96, n_blobs=3,
                                              seed=3), 8),
            "streamed": ((ip, lp), 4)}


def _featurize(pkg, case, arg, **kw):
    if pkg is nyxus_tpu_torch:
        kw["device"] = "cpu"
    if case == "streamed":
        nyx = pkg.Nyxus(FEATS, precision="f64", ram_limit=1, **kw)
        return nyx.featurize_files([arg[0]], [arg[1]])
    return pkg.Nyxus(FEATS, precision="f64", **kw).featurize(*arg)


@pytest.mark.parametrize("case", ["in-memory", "3 ROIs on 8 shards",
                                  "streamed"])
def test_shards_equal_one_device_and_jax(cases, case, monkeypatch):
    arg, n = cases[case]
    streamed = []
    run_streamed = trunner.PairRunner.run_streamed

    def counted(self, *a, **k):
        streamed.append(len(self.devices))
        return run_streamed(self, *a, **k)
    monkeypatch.setattr(trunner.PairRunner, "run_streamed", counted)
    one = _featurize(nyxus_tpu_torch, case, arg)
    many = _featurize(nyxus_tpu_torch, case, arg, n_devices=n)
    assert streamed == ([1, n] if case == "streamed" else [])
    assert len(many) == len(one) > 0
    assert many.columns.equals(one.columns)
    np.testing.assert_allclose(_vals(many), _vals(one), rtol=1e-12,
                               atol=1e-12)
    _same_frames(many, _featurize(nyxus_tpu, case, arg, n_devices=n))


_JAX_3D = r"""
import os, sys
sys.path.insert(0, %(root)r)
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_force_host_platform_device_count=8')
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
jax.config.update('jax_compilation_cache_dir', %(cache)r)
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.2)
import numpy as np
from nyxus_tpu.api import Nyxus3D
I = np.load(%(vol)r); L = np.load(%(lab)r)
df = Nyxus3D(%(feats)r, precision='f64', n_devices=8).featurize(I, L)
df.to_pickle(%(out)r)
"""


def test_3d_shards_equal_one_device_and_jax(tmp_path):
    """Nyxus3D on 8 shards: *3D_ALL* equal to one device at rtol 1e-12,
    and tests/test_parallel.py's 3D request equal to JAX's 8-device run
    (in a subprocess, where JAX's sharded 3D compile runs as that test
    runs it)."""
    vol, lab = make_blobs3d()
    one = nyxus_tpu_torch.Nyxus3D(["*3D_ALL*"], device="cpu",
                                  precision="f64").featurize(vol, lab)
    many = nyxus_tpu_torch.Nyxus3D(["*3D_ALL*"], device="cpu",
                                   precision="f64", n_devices=8)
    got = many.featurize(vol, lab)
    assert len(many._runner.devices) == 8 and len(got) == len(one) > 0
    np.testing.assert_allclose(_vals(got), _vals(one), rtol=1e-12,
                               atol=1e-12)
    np.save(tmp_path / "I.npy", vol)
    np.save(tmp_path / "L.npy", lab)
    out = str(tmp_path / "jax.pkl")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", _JAX_3D % {
        "root": ROOT, "cache": os.path.join(ROOT, ".jax_cache"),
        "vol": str(tmp_path / "I.npy"), "lab": str(tmp_path / "L.npy"),
        "feats": FEATS_3D, "out": out}], env=env, capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    port = nyxus_tpu_torch.Nyxus3D(FEATS_3D, device="cpu", precision="f64",
                                   n_devices=8).featurize(vol, lab)
    _same_frames(port, pd.read_pickle(out))


@pytest.mark.parametrize("n_devices,want", [
    (None, [CPU]), (0, [CPU]), (1, [CPU]), (-1, [CPU]), (2, [CPU] * 2),
    (8, [CPU] * 8)])
def test_roi_devices_on_the_cpu(n_devices, want):
    assert tpar.roi_devices(n_devices, device="cpu") == want


def test_roi_devices_cards():
    """Given devices are kept as they are (cuda:0 twice is two shards on
    one card); past the visible cards ValueError carries roi_mesh's
    message."""
    import jax
    two = tpar.roi_devices(devices=["cuda:0", "cuda:0"])
    assert two == [torch.device("cuda", 0)] * 2
    assert tpar.roi_devices(1) == [torch.device("cuda")]
    avail = torch.cuda.device_count()
    n = max(2, avail + 1)
    with pytest.raises(ValueError) as t:
        tpar.roi_devices(n)
    assert str(t.value) == "requested %d devices, %d available" % (n, avail)
    with pytest.raises(ValueError) as j:
        jpar.roi_mesh(len(jax.devices()) + 1)
    assert str(j.value) == "requested %d devices, %d available" % (
        len(jax.devices()) + 1, len(jax.devices()))


@pytest.mark.parametrize("b,n", [(6, 4), (3, 8), (8, 8), (13, 4), (1, 2),
                                 (5, 1), (9, 8)])
def test_shard_batch_is_jax_partition_less_pad_rows(b, n):
    """Each non-empty shard of the port holds the rows JAX's shard of the
    same index holds, less JAX's row-0 pad rows."""
    a = np.arange(b * 3, dtype=np.float64).reshape(b, 3)
    (sa,), got_b = jpar.shard_batch(jpar.roi_mesh(n), (a,))
    assert got_b == b
    want = []
    for s in sorted(sa.addressable_shards,
                    key=lambda s: s.index[0].start or 0):
        start = s.index[0].start or 0
        rows = np.asarray(s.data)[:max(0, b - start)]
        if len(rows):
            want.append(rows)
    got = tpar.shard_batch([CPU] * n, (a, None))
    assert [k for k, _ in tpar.partition(b, n)] == list(range(len(want)))
    assert len(got) == len(want)
    for (dev, (t, none)), rows in zip(got, want):
        assert dev == CPU and none is None
        np.testing.assert_array_equal(t.numpy(), rows)
    assert [r.tolist() for r in tpar.replicate([CPU] * n, a[0])] == \
        [a[0].tolist()] * n


@pytest.mark.parametrize("env", [None, ("1", "2"), ("0", "2"), ("2", "3")])
def test_process_shard_equals_jax(monkeypatch, env):
    """With no arguments (no process group: process 0 of 1), under the
    environment override, and with explicit arguments, which win over
    it."""
    items = [("i%d.tif" % k, "m%d.tif" % k) for k in range(7)]
    for k in ("NYXUS_PROCESS_INDEX", "NYXUS_PROCESS_COUNT"):
        monkeypatch.delenv(k, raising=False)
    if env is not None:
        monkeypatch.setenv("NYXUS_PROCESS_INDEX", env[0])
        monkeypatch.setenv("NYXUS_PROCESS_COUNT", env[1])
    got = tpar.process_shard(items)
    assert got == jpar.process_shard(items)
    if env is None:
        assert got == items
    else:
        assert got == items[int(env[0])::int(env[1])]
    assert tpar.process_shard(items, 1, 3) == \
        jpar.process_shard(items, 1, 3) == items[1::3]


_WORKER = r"""
import os, sys
sys.path.insert(0, %(root)r)
import torch
torch.set_num_threads(1)
from nyxus_tpu_torch import Nyxus
from nyxus_tpu_torch.parallel import initialize_distributed
if %(dist)r:
    initialize_distributed(coordinator_address=%(coord)r, num_processes=2,
                           process_id=%(pid)d)
    import torch.distributed as dist
    assert dist.get_rank() == %(pid)d and dist.get_world_size() == 2
    initialize_distributed(coordinator_address=%(coord)r, num_processes=2,
                           process_id=%(pid)d)   # a second call: no-op
df = Nyxus(%(feats)r, device="cpu", precision="f64",
           shard_slides=True).featurize_directory(%(intdir)r, %(segdir)r)
df.to_pickle(%(out)r)
assert not [m for m in sys.modules
            if m in ("jax", "nyxus_tpu") or m.startswith("nyxus_tpu.")]
if %(dist)r:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    """Five 96 x 96 TIFF pairs of two ROIs each (after
    tests/test_distributed.py's corpus), written by the port's writer."""
    root = tmp_path_factory.mktemp("shards")
    intd, segd = root / "int", root / "seg"
    intd.mkdir()
    segd.mkdir()
    r = np.random.default_rng(2)
    for s in range(5):
        img = r.integers(1, 5000, (96, 96)).astype(np.uint16)
        lab = np.zeros((96, 96), np.uint16)
        lab[8:40, 8:40] = 1
        lab[50:90, 30 + s:80] = 2
        write_tiff(str(intd / ("s%d.tif" % s)), img, tile_size=64)
        write_tiff(str(segd / ("s%d.tif" % s)), lab, tile_size=64)
    return str(intd), str(segd)


@pytest.mark.parametrize("how", ["environment", "initialize_distributed"])
def test_two_processes_shard_slides(shard_dirs, tmp_path, monkeypatch, how):
    intd, segd = shard_dirs
    dist = how == "initialize_distributed"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = "localhost:%d" % s.getsockname()[1]
    procs, outs = [], []
    for pid in range(2):
        out = str(tmp_path / ("shard%d.pkl" % pid))
        outs.append(out)
        env = dict(os.environ)
        for k in ("NYXUS_PROCESS_INDEX", "NYXUS_PROCESS_COUNT"):
            env.pop(k, None)
        if not dist:
            env["NYXUS_PROCESS_INDEX"] = str(pid)
            env["NYXUS_PROCESS_COUNT"] = "2"
        code = _WORKER % {"root": ROOT, "dist": dist, "coord": coord,
                          "pid": pid, "feats": SHARD_FEATS, "intdir": intd,
                          "segdir": segd, "out": out}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, cwd=str(tmp_path)))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    parts = [pd.read_pickle(o) for o in outs]

    names = sorted("s%d.tif" % k for k in range(5))
    seen = [sorted({os.path.basename(m) for m in p.mask_image})
            for p in parts]
    assert seen == [names[0::2], names[1::2]]
    key = ["mask_image", "ROI_label"]
    union = pd.concat(parts).sort_values(key).reset_index(drop=True)
    whole = nyxus_tpu_torch.Nyxus(SHARD_FEATS, device="cpu",
                                  precision="f64").featurize_directory(
        intd, segd).sort_values(key).reset_index(drop=True)
    pd.testing.assert_frame_equal(union, whole)
    for pid, part in enumerate(parts):
        monkeypatch.setenv("NYXUS_PROCESS_INDEX", str(pid))
        monkeypatch.setenv("NYXUS_PROCESS_COUNT", "2")
        want = nyxus_tpu.Nyxus(SHARD_FEATS, precision="f64",
                               shard_slides=True).featurize_directory(
            intd, segd)
        _same_frames(part.reset_index(drop=True), want)

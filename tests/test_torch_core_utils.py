"""The rest of core/ and utils/ of pcl_tpu_torch against the JAX package's on
the CPU: spring border ops, intersections, console helpers, the cloud
generators and logging.

- Spring: every op's xyz, mask, attributes (of one, three and integer
  columns) and shape equal, with amounts larger than a side, where numpy's
  ``symmetric`` pad repeats the reflection.
- Intersections and console: the port copies the JAX modules; their
  results are equal.
- Generators: the cores fed the JAX package's own draws of the same
  ``split`` keys agree within one ulp of the range's magnitude (C17).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import logging
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pcl_tpu.core import intersections as jint
from pcl_tpu.core import spring as jspring
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.utils import console as jcon
from pcl_tpu.utils import generate as jgen
from pcl_tpu.utils import logging as jlog

from pcl_tpu_torch.core import intersections as tint
from pcl_tpu_torch.core import spring as tspring
from pcl_tpu_torch.core.cloud import Cloud as TCloud
from pcl_tpu_torch.utils import console as tcon
from pcl_tpu_torch.utils import generate as tgen
from pcl_tpu_torch.utils import logging as tlog


def _organized(h, w, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (h * w, 3)).astype(np.float32)
    mask = rng.uniform(size=h * w) > 0.2
    attrs = {"normal": rng.normal(size=(h * w, 3)).astype(np.float32),
             "intensity": rng.uniform(size=h * w).astype(np.float32),
             "label": rng.integers(0, 9, h * w).astype(np.int32)}
    j = JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask),
               attrs={k: jnp.asarray(v) for k, v in attrs.items()}, width=w, height=h)
    t = TCloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask),
               attrs={k: torch.from_numpy(v) for k, v in attrs.items()}, width=w, height=h)
    return j, t


def _assert_clouds_equal(t, j):
    assert (t.height, t.width) == (j.height, j.width)
    np.testing.assert_array_equal(t.xyz.numpy(), np.asarray(j.xyz))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert set(t.attrs) == set(j.attrs)
    for k in t.attrs:
        assert t.attrs[k].numpy().dtype == np.asarray(j.attrs[k]).dtype, k
        np.testing.assert_array_equal(t.attrs[k].numpy(), np.asarray(j.attrs[k]), err_msg=k)


SPRING_OPS = [
    ("expand_rows", ([7.0, 8.0, 9.0], 2)), ("expand_columns", (None, 5)),
    ("duplicate_rows", (4,)), ("duplicate_columns", (1,)),
    ("mirror_rows", (2,)), ("mirror_rows", (7,)), ("mirror_columns", (9,)),
    ("delete_rows", (1,)), ("delete_cols", (2,)),
]


@pytest.mark.parametrize("op,args", SPRING_OPS,
                         ids=[f"{op}-{args[-1]}" for op, args in SPRING_OPS])
def test_spring_ops_match_jax(op, args):
    """On a 3 x 5 cloud: amounts up to three times a side."""
    j, t = _organized(3, 5)
    _assert_clouds_equal(getattr(tspring, op)(t, *args), getattr(jspring, op)(j, *args))


@pytest.mark.parametrize("policy,pads", [
    ("constant", (1, 2, 3, 1)), ("replicate", (4, 0, 0, 6)), ("reflect", (0, 5, 7, 1)),
    ("reflect", (2, 2, 2, 2))])
def test_copy_make_border_matches_jax(policy, pads):
    j, t = _organized(3, 4, seed=2)
    value = [7.0, 7.0, 7.0] if policy == "constant" else None
    _assert_clouds_equal(tspring.copy_make_border(t, *pads, policy, value),
                         jspring.copy_make_border(j, *pads, policy, value))


def test_spring_refuses_what_jax_refuses():
    j, t = _organized(3, 4)
    for mod, c in ((jspring, j), (tspring, t)):
        with pytest.raises(ValueError):
            mod.copy_make_border(c, 1, 1, 1, 1, "wrap")
    flat = TCloud(xyz=t.xyz, mask=t.mask, width=0, height=1)
    with pytest.raises(ValueError):
        tspring.mirror_rows(flat, 1)


def test_intersections_match_jax():
    rng = np.random.default_rng(4)
    cases = [([0.01, 0.02, 0.03, 0.4, 0.5, 0.6], [0.1, 0.2, 0.3, 0.04, 0.05, 0.06]),
             ([0.001, 0.002, 0.003, 0.004, 0.005, 0.006],
              [0.00157, 0.00233, 0.00378, 0.00495, 0.00565, 0.00666]),
             ([0, 0, 0, 1, 0, 0], [0, 1, 0, 2, 0, 0])]           # parallel
    cases += [tuple(rng.normal(size=(2, 6))) for _ in range(5)]
    for a, b in cases:
        for x, y in zip(tint.line_to_line_segment(a, b), jint.line_to_line_segment(a, b)):
            np.testing.assert_array_equal(x, y)
        for eps in (1e-4, 1e-1):
            ok, p = tint.line_with_line_intersection(a, b, eps)
            jok, jp = jint.line_with_line_intersection(a, b, eps)
            assert ok == jok
            np.testing.assert_array_equal(p, jp)
    planes = [[1.0, 2.0, 3.0, 0.0], [1.0, 2.0, 3.0, 1.0], [1.0, 2.5, 3.0, 0.5],
              [0.0, 0.0, 1.0, 0.0], [1.0, 0.0, 0.0, -0.5], [24.234, -22.234, 3.0823, -24.5],
              [689.0, 1239.01, 1.0003, 0.5]] + [list(rng.normal(size=4)) for _ in range(4)]
    for pa in planes:
        for pb in planes:
            for tol in (1e-6, 0.1):
                ok, line = tint.plane_with_plane_intersection(pa, pb, tol)
                jok, jline = jint.plane_with_plane_intersection(pa, pb, tol)
                assert ok == jok
                np.testing.assert_array_equal(line, jline)
            for pc in planes[::3]:
                ok, pt = tint.three_planes_intersection(pa, pb, pc)
                jok, jpt = jint.three_planes_intersection(pa, pb, pc)
                assert ok == jok
                np.testing.assert_array_equal(pt, jpt)


def test_console_helpers_match_jax():
    argv = ["prog", "a.pcd", "-leaf", "0.25", "-xyz", "1,2,3", "-v", "b.PCD", "c.ply"]
    for mod in (tcon, jcon):
        assert mod.find_switch(argv, "-v") and not mod.find_switch(argv, "-q")
    assert tcon.parse_argument(argv, "-leaf", float) == jcon.parse_argument(argv, "-leaf", float)
    assert tcon.parse_argument(argv, "-none") is None
    assert tcon.parse_x_arguments(argv, "-xyz", 3) == jcon.parse_x_arguments(argv, "-xyz", 3)
    with pytest.raises(ValueError):
        tcon.parse_x_arguments(argv, "-xyz", 2)
    assert tcon.parse_file_extension_argument(argv, "pcd") == \
        jcon.parse_file_extension_argument(argv, ".pcd") == [1, 7]
    for sigma, size, deriv in ((1.0, None, False), (2.5, 9, True), (0.7, None, True)):
        np.testing.assert_array_equal(tcon.gaussian_kernel_1d(sigma, size, deriv),
                                      jcon.gaussian_kernel_1d(sigma, size, deriv))
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, 50)
    y = 1 + 2 * x - 0.5 * x ** 3 + 0.01 * rng.normal(size=50)
    w = rng.uniform(0.5, 1.5, 50)
    for weights in (None, w):
        c = tcon.fit_polynomial(x, y, 3, weights)
        np.testing.assert_array_equal(c, jcon.fit_polynomial(x, y, 3, weights))
        np.testing.assert_array_equal(tcon.eval_polynomial(c, x), jcon.eval_polynomial(c, x))


def test_time_trigger_and_synchronizer():
    """The trigger fires every callback on its thread until stopped; the
    synchronizer hands over pairs in arrival order, as the JAX package's."""
    for mod in (tcon, jcon):
        fired, other = [], []
        trig = mod.TimeTrigger(0.01, lambda: fired.append(threading.get_ident()))
        trig.register_callback(lambda: other.append(1))
        trig.set_interval(0.005)
        trig.start()
        trig.start()                                   # a second start is a no-op
        deadline = time.monotonic() + 5.0
        while len(fired) < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        trig.stop()
        n = len(fired)
        time.sleep(0.03)
        assert n >= 3 and len(fired) == n and len(other) >= n - 1
        assert threading.get_ident() not in fired
    got = {}
    for name, mod in (("port", tcon), ("jax", jcon)):
        s = mod.Synchronizer()
        out = []
        s.register_callback(lambda a, b, ta, tb: out.append((a, b, ta, tb)))
        s.add0("a0", 1.0)
        s.add0("a1", 2.0)
        s.add1("b0", 1.5)
        s.add1("b1", 2.5)
        s.add1("b2", 3.0)
        got[name] = out
    assert got["port"] == got["jax"] == [("a0", "b0", 1.0, 1.5), ("a1", "b1", 2.0, 2.5)]


@pytest.mark.parametrize("kind", ["uniform", "normal"])
def test_generator_cores_on_the_jax_draws(kind):
    """The JAX generators' own keys and draws (``split`` of the key, one
    ``uniform``/``normal`` per axis) fed to the port's cores."""
    key = jax.random.PRNGKey(7)
    w, h = 40, 30
    if kind == "uniform":
        spec = ((0.0, 1.0), (-1.0, 1.0), (-2.5, 1.5))
        jc = jgen.generate_cloud_uniform(key, w, h, spec)
        draws = [jax.random.uniform(k, (w * h,), jnp.float32) for k in jax.random.split(key, 3)]
        tc = tgen.generate_cloud_uniform_core(torch.from_numpy(np.stack(draws)), w, h, spec)
        mag = np.float32([max(abs(lo), abs(hi)) for lo, hi in spec])
    else:
        spec = ((2.0, 0.5), (-1.0, 2.0), (0.0, 1.0))
        jc = jgen.generate_cloud_normal(key, w, h, spec)
        draws = [jax.random.normal(k, (w * h,), jnp.float32) for k in jax.random.split(key, 3)]
        tc = tgen.generate_cloud_normal_core(torch.from_numpy(np.stack(draws)), w, h, spec)
        mag = np.abs(np.asarray(jc.xyz)).max(0)
    assert (tc.width, tc.height, tc.capacity) == (jc.width, jc.height, jc.capacity)
    assert tc.mask.all()
    assert (np.abs(tc.xyz.numpy() - np.asarray(jc.xyz)) <= np.spacing(mag)).all()


def test_generator_samplers_and_split():
    g = torch.Generator().manual_seed(3)
    c = tgen.generate_cloud_uniform(g, 480, 64, ((0, 1), (-1, 1), (-2.5, 1.5)))
    x = c.xyz.numpy()
    assert c.capacity == 480 * 64 and (c.width, c.height) == (480, 64)
    assert (x[:, 0] >= 0).all() and (x[:, 0] < 1).all() and (x[:, 2] >= -2.5).all() \
        and (x[:, 2] < 1.5).all()
    n = tgen.generate_cloud_normal(torch.Generator().manual_seed(4), 200, 200,
                                   ((2.0, 0.5), (-1.0, 2.0), (0.0, 1.0))).xyz.numpy()
    np.testing.assert_allclose(n.mean(0), [2.0, -1.0, 0.0], atol=0.05)
    np.testing.assert_allclose(n.std(0), [0.5, 2.0, 1.0], atol=0.05)
    a = tgen.generate_cloud_uniform(torch.Generator().manual_seed(5), 8).xyz
    b = tgen.generate_cloud_uniform(torch.Generator().manual_seed(5), 8).xyz
    assert torch.equal(a, b) and a.device.type == "cpu"      # the generator's draws
    for text in ("", "\r\t ", "abcd", "aabb ccdd\reeff\tgghh \riijj \tkkll\r\tmmnn \r\toopp",
                 "  a,b;;c  ", "x\t\ty"):
        for delims in (" \r\t", ",;", " "):
            assert tgen.split(text, delims) == jgen.split(text, delims)


def test_logging_has_its_own_root_and_the_jax_levels(monkeypatch):
    assert tlog._LEVELS == jlog._LEVELS
    assert tlog.get_logger().name == "pcl_tpu_torch"
    assert tlog.get_logger("io").name == "pcl_tpu_torch.io"
    root, jroot = logging.getLogger("pcl_tpu_torch"), logging.getLogger("pcl_tpu")
    before, jbefore = root.level, jroot.level
    try:
        tlog.set_verbosity("debug")
        assert root.level == logging.DEBUG and jroot.level == jbefore
        tlog.set_verbosity("VERBOSE")
        assert root.level == 5
        monkeypatch.setenv("PCL_TPU_VERBOSITY", "error")
        tlog._init()
        assert root.level == logging.ERROR and len(root.handlers) == 1
        with pytest.raises(KeyError):
            tlog.set_verbosity("loud")
    finally:
        root.setLevel(before)

"""Port parity: texture evaluation (hash-lattice Perlin noise, marble
turbulence, image point fetches, checker nesting).

The same numpy inputs go through ``mort_tpu.render.textures`` and
``mort_tpu_torch.render.textures``.  The lattice hashes are integer
arithmetic and must agree bit for bit; the noise values are float32
polynomials of the same fractions (1e-6 abs); the image texels are exact.

The marble kernel's route (``csrc/noise.cu``) is taken on card operands
with no gradient recorded; here the library is stubbed, or the kernel's
source is built for the CPU against a stand-in CUDA header.
"""

import contextlib
import ctypes
import dataclasses
import re
import subprocess
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mort_tpu.render import textures as jtx
from mort_tpu.scene import scenes as jsc
from chip_smoke import noise_lattice
from mort_tpu_torch import _build
from mort_tpu_torch.render import textures as ttx
from mort_tpu_torch.scene.build import World, scene_from_numpy
from mort_tpu_torch.scene.types import TEX_IMAGE, TEX_NOISE, TEX_SOLID


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("salt", [0, 0x51ED270B, 0xA3DA4E16, 0xFFFFFFFF])
def test_hash3_bit_equal(salt):
    ijk = noise_lattice(4096)
    want = np.asarray(jtx._hash3(*(jnp.asarray(ijk[:, k]) for k in range(3)),
                                 salt)).astype(np.int64)
    got = ttx._hash3(*(torch.from_numpy(ijk[:, k]) for k in range(3)), salt)
    assert got.dtype == torch.int64
    assert ((got >= 0) & (got < 2 ** 32)).all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_corner_hashes_bit_equal():
    """The shared-product corner hashes of ``_perlin_noise`` ((i+1)*H as
    i*H + H mod 2^32) equal independent ``_hash3`` calls, on both sides."""
    ijk = noise_lattice(4096, seed=1)
    salt = jtx.noise_salt(0)
    assert ttx.noise_salt(0) == salt
    hx0 = ttx._mullo(ttx._u32(torch.from_numpy(ijk[:, 0])), ttx._HX)
    hy0 = ttx._mullo(ttx._u32(torch.from_numpy(ijk[:, 1])), ttx._HY)
    hz0 = ttx._mullo(ttx._u32(torch.from_numpy(ijk[:, 2])), ttx._HZ)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                c = ijk.astype(np.int64) + [di, dj, dk]
                c = ((c + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
                want = np.asarray(jtx._hash3(
                    *(jnp.asarray(c[:, k]) for k in range(3)),
                    salt)).astype(np.int64)
                h = ((hx0 + di * ttx._HX) & ttx._M32) ^ \
                    ((hy0 + dj * ttx._HY) & ttx._M32) ^ \
                    ((hz0 + dk * ttx._HZ) & ttx._M32)
                got = ttx._avalanche(h, salt)
                np.testing.assert_array_equal(got.numpy(), want)


def _points(n=4096, seed=2, scale=40.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [0.5, 40.0, 900.0])
def test_perlin_and_turbulence_match_jax(scale):
    p = _points(scale=scale)
    salt = jtx.noise_salt(1)
    want = np.asarray(jtx._perlin_noise(jnp.asarray(p), salt))
    got = ttx._perlin_noise(torch.from_numpy(p), salt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(jtx._turbulence(jnp.asarray(p), salt))
    got = ttx._turbulence(torch.from_numpy(p), salt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("idx", [2, 3, 4, 8])
def test_texture_value_matches_jax(idx):
    """Every texture row of the scene at random (u, v, p): checker (2),
    image (3, 8), noise (4, 8) and solid colours."""
    jdata, jmeta = jsc.build_scene(idx)[0].compile()
    data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    T = len(meta.tex_kind)
    rs = np.random.RandomState(idx)
    n = 4096
    tid = rs.randint(0, T, n).astype(np.int32)
    u = rs.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rs.uniform(-0.1, 1.1, n).astype(np.float32)
    p = (rs.randn(n, 3) * 300.0).astype(np.float32)
    want = np.asarray(jtx.texture_value(jdata, jmeta, jnp.asarray(tid),
                                        jnp.asarray(u), jnp.asarray(v),
                                        jnp.asarray(p)))
    got = ttx.texture_value(data, meta, torch.from_numpy(tid),
                            torch.from_numpy(u), torch.from_numpy(v),
                            torch.from_numpy(p)).numpy()
    assert got.shape == (n, 3) and got.dtype == np.float32
    kinds = np.asarray(meta.tex_kind)[tid]
    noise = kinds == TEX_NOISE
    # image texels and solid colours exactly; noise within 1e-5
    np.testing.assert_array_equal(got[~noise], want[~noise])
    np.testing.assert_allclose(got[noise], want[noise], rtol=0, atol=1e-5)
    if idx in (3, 8):
        assert (kinds == TEX_IMAGE).any()
    if idx in (4, 8):
        assert noise.any()


# -- the marble kernel's route (csrc/noise.cu) -------------------------------


def _noise_world():
    """Two noise textures (two salts, two scales), one reached through a
    checker, beside a solid colour."""
    w = World()
    solid = w.solid_color([0.2, 0.4, 0.6])
    n0 = w.noise_texture(4.0)
    n1 = w.noise_texture(0.1)
    chk = w.checker(0.5, n1, solid)
    for k, tex in enumerate((solid, n0, n1, chk)):
        w.sphere([3.0 * k, 0.0, 0.0], 1.0, w.lambertian(tex))
    return w.compile()


def _lanes(meta, n=2048, seed=5, scale=40.0):
    rs = np.random.RandomState(seed)
    tid = torch.from_numpy(rs.randint(0, len(meta.tex_kind), n)
                           .astype(np.int32))
    u = torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32))
    v = torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32))
    p = torch.from_numpy((rs.randn(n, 3) * scale).astype(np.float32))
    return tid, u, v, p


def _view(ptr, ctype, shape):
    """A CPU tensor over ``shape`` elements at address ``ptr``."""
    return torch.from_numpy(np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=shape))


def _stand_in(calls, rc=0):
    """The noise library stubbed: ``mort_noise_marble`` records its
    arguments and, when it returns 0, writes ``marble_plain`` of the
    operands at its pointers, each noise texture of the table in turn,
    into its output, as the kernel would."""
    class Lib:
        @staticmethod
        def mort_noise_marble(p, tid, kind, noise_id, scale, n_tex,
                              kind_noise, x_in, x_out, n, stream):
            calls.append(dict(p=p, tid=tid, kind=kind, noise_id=noise_id,
                              scale=scale, n_tex=n_tex,
                              kind_noise=kind_noise, x_in=x_in, x_out=x_out,
                              n=n, stream=stream))
            if rc == 0:
                rows = _view(tid, ctypes.c_int64, (n,))
                data = types.SimpleNamespace(
                    tex_image_id=_view(noise_id, ctypes.c_int32, (n_tex,)),
                    tex_noise_scale=_view(scale, ctypes.c_float, (n_tex,)))
                kind_arr = _view(kind, ctypes.c_int32, (n_tex,))
                x = _view(x_in, ctypes.c_float, (n, 3)).clone()
                for nid in data.tex_image_id[kind_arr == kind_noise].tolist():
                    x = ttx.marble_plain(data, kind_arr[rows], rows,
                                         _view(p, ctypes.c_float, (n, 3)),
                                         x, nid)
                _view(x_out, ctypes.c_float, (n, 3))[:] = x
            return rc
    return Lib


@pytest.fixture
def card_stand_in(monkeypatch):
    """CPU tensors taken for card operands and the library stubbed
    (``_stand_in``); yields the list of its calls."""
    calls = []
    monkeypatch.setattr(ttx, "_card", lambda t: True)
    monkeypatch.setattr(_build, "load_library",
                        lambda name: _stand_in(calls))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))
    return calls


def _moved(before):
    return {k: ttx.launch_count[k] - n for k, n in before.items()}


def test_cpu_operands_take_the_plain_route():
    """CPU operands evaluate each noise texture by ``marble_plain``,
    counted under "plain", with or without autograd."""
    data, meta = _noise_world()
    assert meta.n_noise == 2
    tid, u, v, p = _lanes(meta)
    before = dict(ttx.launch_count)
    with torch.no_grad():
        got = ttx.texture_value(data, meta, tid, u, v, p)
    want = ttx.texture_value(data, meta, tid, u, v, p)
    assert _moved(before) == {"kernel": 0, "plain": 4}
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["no_grad", "grad, no leaf", "p",
                                  "tex_color", "tex_noise_scale"])
def test_kernel_route_only_without_a_gradient(card_stand_in, monkeypatch,
                                              case):
    """On card operands the kernel evaluates every noise texture in one
    launch unless autograd records a gradient through the points, the
    colours or the noise scales: that takes the plain route, one
    evaluation a noise texture, with the plain route's gradient."""
    data, meta = _noise_world()
    tid, u, v, p = _lanes(meta)
    leaf = None
    if case == "no_grad":
        p = p.clone().requires_grad_()
    elif case == "p":
        p = leaf = p.clone().requires_grad_()
    elif case != "grad, no leaf":
        leaf = getattr(data, case).clone().requires_grad_()
        data = data.replace(**{case: leaf})
    before = dict(ttx.launch_count)
    with torch.no_grad() if case == "no_grad" else contextlib.nullcontext():
        got = ttx.texture_value(data, meta, tid, u, v, p)
    kernel = leaf is None
    assert _moved(before) == {"kernel": int(kernel), "plain": 2 * (not kernel)}
    assert len(card_stand_in) == kernel
    for call in card_stand_in:
        assert (call["kind_noise"], call["n"], call["n_tex"],
                call["stream"]) == (TEX_NOISE, len(tid), len(meta.tex_kind),
                                    77)
        assert call["p"] == p.data_ptr()
        assert call["x_out"] == got.data_ptr()
    monkeypatch.setattr(ttx, "_card", lambda t: False)
    want = ttx.texture_value(data, meta, tid, u, v, p)
    assert torch.equal(got.detach(), want.detach())
    if leaf is not None:
        w = torch.linspace(-1.0, 1.0, 3 * len(tid)).reshape(-1, 3)
        (g,) = torch.autograd.grad((got * w).sum(), leaf)
        (g_want,) = torch.autograd.grad((want * w).sum(), leaf)
        assert torch.equal(g, g_want) and g.abs().sum() > 0


def _marble_operands(meta, data, n=64):
    kind_arr = torch.tensor(meta.tex_kind, dtype=torch.int32)
    tid, _, _, p = _lanes(meta, n=n)
    return kind_arr, tid.long(), p, data.tex_color[tid.long()]


@pytest.mark.parametrize("case", ["launch", "refused launch", "no lanes",
                                  "float64 points"])
def test_kernel_count_counts_launches(monkeypatch, case):
    """``launch_count["kernel"]`` counts launches the runtime accepted: a
    refused launch, a call of no lanes and a refused operand leave it as
    it was (and the last two launch nothing)."""
    data, meta = _noise_world()
    kind_arr, tid, p, out = _marble_operands(meta, data)
    calls = []
    monkeypatch.setattr(_build, "load_library", lambda name: _stand_in(
        calls, rc=1 if case == "refused launch" else 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    if case == "no lanes":
        tid, p, out = tid[:0], p[:0], out[:0]
    if case == "float64 points":
        p = p.double()
    error = {"refused launch": RuntimeError,
             "float64 points": TypeError}.get(case)
    before = dict(ttx.launch_count)
    with pytest.raises(error) if error else contextlib.nullcontext():
        got = ttx.marble_kernel(data, kind_arr, tid, p, out)
    assert len(calls) == (case in ("launch", "refused launch"))
    assert _moved(before) == {"kernel": int(case == "launch"), "plain": 0}
    if case == "no lanes":
        assert got.shape == (0, 3)


@pytest.mark.parametrize("case", [
    "p float64", "tid int32", "out float16", "kinds int64",
    "tex_image_id int64", "tex_noise_scale float64", "p on meta",
    "tid on meta", "scale on meta", "p [R, 2]", "out [R - 1, 3]",
    "tid [R, 1]", "kinds of another length"])
def test_marble_kernel_refuses_bad_operands(monkeypatch, case):
    """The wrapper refuses a wrong dtype (TypeError), device or shape
    (ValueError) before any launch."""
    data, meta = _noise_world()
    kind_arr, tid, p, out = _marble_operands(meta, data)
    calls = []
    monkeypatch.setattr(_build, "load_library",
                        lambda name: _stand_in(calls))
    meta_dev = torch.device("meta")
    if case == "p float64":
        p = p.double()
    elif case == "tid int32":
        tid = tid.int()
    elif case == "out float16":
        out = out.half()
    elif case == "kinds int64":
        kind_arr = kind_arr.long()
    elif case == "tex_image_id int64":
        data = data.replace(tex_image_id=data.tex_image_id.long())
    elif case == "tex_noise_scale float64":
        data = data.replace(tex_noise_scale=data.tex_noise_scale.double())
    elif case == "p on meta":
        p = p.to(meta_dev)
    elif case == "tid on meta":
        tid = tid.to(meta_dev)
    elif case == "scale on meta":
        data = data.replace(tex_noise_scale=data.tex_noise_scale.to(
            meta_dev))
    elif case == "p [R, 2]":
        p = p[:, :2]
    elif case == "out [R - 1, 3]":
        out = out[1:]
    elif case == "tid [R, 1]":
        tid = tid[:, None]
    else:
        kind_arr = torch.cat([kind_arr, kind_arr[:1]])
    error = TypeError if " " in case and case.split()[-1] in (
        "float64", "int32", "float16", "int64") else ValueError
    before = dict(ttx.launch_count)
    with pytest.raises(error, match="marble_kernel"):
        ttx.marble_kernel(data, kind_arr, tid, p, out)
    assert calls == [] and ttx.launch_count == before


# The kernel's source on the CPU: a small header stands in for the CUDA
# runtime (one loop over blocks and threads a launch; the __f*_rn
# intrinsics through volatile floats, no FMA contraction), g++ builds it,
# and the wrapper calls it as it calls the card's library.
_SHIM = r"""
#include <cmath>
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __restrict__
typedef void* cudaStream_t;
struct MortEmuDim { unsigned x; };
static MortEmuDim blockIdx, threadIdx;
template <class T> static T __ldg(const T* p) { return *p; }
static float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
static int cudaGetLastError() { return 0; }
extern "C" float mort_emu_identity(float x) { return x; }
extern "C" { float (*mort_emu_sin)(float) = ::sinf; }
#define sinf(x) mort_emu_sin(x)
"""


def _launch_as_loops(m):
    grid, block = (a.strip() for a in m.group(2).split(",")[:2])
    return (f"for (unsigned mort_b = 0; mort_b < (unsigned)({grid}); "
            f"++mort_b) for (unsigned mort_t = 0; mort_t < "
            f"(unsigned)({block}); ++mort_t) {{ blockIdx.x = mort_b; "
            f"threadIdx.x = mort_t; {m.group(1)}({m.group(3)}); }}")


@pytest.fixture(scope="module")
def noise_on_cpu(tmp_path_factory):
    """``csrc/noise.cu`` built by g++ against ``_SHIM``, its signatures
    declared from ``_build.SIGNATURES``."""
    tmp = tmp_path_factory.mktemp("noise_emu")
    (tmp / "cuda_runtime.h").write_text(_SHIM)
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);", _launch_as_loops,
                     (_build.CSRC / "noise.cu").read_text(), flags=re.S)
    assert n == 1
    (tmp / "noise.cpp").write_text(src)
    lib_path = tmp / "libnoise_emu.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", f"-I{tmp}", "-o", str(lib_path),
                    str(tmp / "noise.cpp")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, (restype, argtypes) in _build.SIGNATURES["noise"].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


@pytest.mark.parametrize("sin", ["identity", "libm"])
@pytest.mark.parametrize("case", ["scene4", "scene9", "two noise",
                                  "lattice"])
def test_kernel_source_equals_plain_on_the_cpu(noise_on_cpu, monkeypatch,
                                               case, sin):
    """``texture_value`` through the kernel's source (built for the CPU)
    against the plain route: bit for bit with sin taken out of both (the
    lattice hash, the turbulence and the marble's arithmetic), within
    1e-6 with each side's own sin (the C library's sinf against torch's);
    lanes of other textures exact."""
    if case == "two noise":
        data, meta = _noise_world()
    else:
        w = jsc.build_scene(4 if case != "scene9" else 9)[0]
        jdata, jmeta = w.compile()
        data, meta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    rs = np.random.RandomState(len(case))
    n = 4096
    if case == "lattice":
        # s = scale * p on noise_lattice's points (int32 extremes included)
        row = list(meta.tex_kind).index(TEX_NOISE)
        tid = torch.full((n,), row, dtype=torch.int32)
        s = noise_lattice(n).astype(np.float64) + rs.uniform(0, 1, (n, 3))
        p = torch.from_numpy((s / float(data.tex_noise_scale[row]))
                             .astype(np.float32))
    else:
        # every texture row, and a noise row on every other lane
        rows = rs.randint(0, len(meta.tex_kind), n)
        rows[::2] = rs.choice(np.flatnonzero(np.asarray(meta.tex_kind)
                                             == TEX_NOISE), n // 2)
        tid = torch.from_numpy(rows.astype(np.int32))
        p = torch.from_numpy(np.concatenate([
            rs.randn(n // 3, 3) * 0.5, rs.randn(n // 3, 3) * 40.0,
            rs.randn(n - 2 * (n // 3), 3) * 900.0]).astype(np.float32))
    u = torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32))
    v = torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32))
    sin_fn = ctypes.c_void_p.in_dll(noise_on_cpu, "mort_emu_sin")
    default_sin = sin_fn.value
    if sin == "identity":
        sin_fn.value = ctypes.cast(noise_on_cpu.mort_emu_identity,
                                   ctypes.c_void_p).value
        monkeypatch.setattr(torch, "sin", lambda x: x)
    try:
        want = ttx.texture_value(data, meta, tid, u, v, p)
        monkeypatch.setattr(ttx, "_card", lambda t: True)
        monkeypatch.setattr(_build, "load_library",
                            lambda name: noise_on_cpu)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d=None: types.SimpleNamespace(
                                cuda_stream=0))
        before = dict(ttx.launch_count)
        with torch.no_grad():
            got = ttx.texture_value(data, meta, tid, u, v, p)
    finally:
        sin_fn.value = default_sin
    assert _moved(before) == {"kernel": 1, "plain": 0}
    kinds = torch.tensor(meta.tex_kind)[tid.long()]
    # a checker cell may have a noise child
    noise = kinds != TEX_SOLID
    assert (kinds == TEX_NOISE).float().mean() >= 0.5
    if sin == "identity":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        assert torch.equal(got[~noise], want[~noise])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)

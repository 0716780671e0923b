"""The device loop's seed word (``renderer._FrameState.seed_word``): one kept
entry serves every seed of a sampled frame.

On the CPU (``frame_device``'s schedule through the plain versions, which
read the staged word on the host):

* ``frame_key`` is the same for any seed, with the stochastic camera, a
  light sampler or both;
* seeds a, b, a in turns through ``frame_device`` are one entry: a miss,
  then two hits, each ``frame_eager``'s bits at its own seed, the loop
  span's ``seed_new`` 0, 1, 1 (and 0 on a repeat of the last seed);
* the word holds the seed's 32 bits as an i32, so seeds that agree in
  their low 32 bits give the same frame;
* the K7 and K8 wrappers take an int seed by value and a (1,) i32 word by
  pointer, and refuse a word of another dtype or shape.

On the card (marker ``cuda``): seeds a, b, a through the kept CUDA graph,
one entry and one capture, each its seed's eager frame. The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_seed_word.py
"""

import numpy as np
import pytest
import torch

from test_torch_kernels import _area_grad_scene, _area_hair_host
from torch_card import cuda_device  # noqa: F401  (fixture)
from yocto_raytracing_tpu_torch import kernels
from yocto_raytracing_tpu_torch import scene as scene_lib
from yocto_raytracing_tpu_torch.render import camera, lights, renderer
from yocto_raytracing_tpu_torch.utils import tracer

# 384 pixels in chunks of 150: two whole chunks and a tail of 84 (CPU)
W, H, SAMPLES, DEPTH, CHUNK = 24, 16, 2, 4, 150
SEEDS = (3, 2**31 + 11)       # a, b: b's word is a negative i32
HOSTS = {"area_hair": _area_hair_host,
         "area_mirror": lambda: _area_grad_scene(0.2)}


def _case(name, device, stochastic=True, sampler=True):
    host = HOSTS[name]()
    leaves, meta = scene_lib.build_device_scene(host)
    ts = scene_lib.to_torch(leaves, device)
    kw = dict(max_depth=DEPTH, chunk_pixels=CHUNK, stochastic=stochastic,
              light_sampler=(lights.build_light_sampler(host, leaves, meta,
                                                        device)
                             if sampler else None))
    return ts, meta, kw


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


def _served(ts, meta, seeds, w=W, h=H, **kw):
    """Each seed's ``frame_device`` frame on the host, its record's
    ``cache_hit`` and its loop span's ``seed_new``."""
    out = []
    with tracer.recording():
        for seed in seeds:
            tracer.clear()
            got = renderer.frame_device(ts, meta, w, h, SAMPLES, seed=seed,
                                        **kw)
            (sp,) = [s for s in tracer.spans() if s.name == "frame_device"]
            out.append((got[:w * h].cpu().numpy().copy(),
                        kernels.last_frame()["cache_hit"],
                        sp.attrs["seed_new"]))
    tracer.clear()
    return out


@pytest.mark.parametrize("mode", ["stochastic", "sampler", "both"])
def test_frame_key_is_equal_across_seeds(mode):
    ts, meta, kw = _case("area_mirror", "cpu", mode != "sampler",
                         mode != "stochastic")
    keys = {renderer.frame_key(ts, meta, W, H, SAMPLES, DEPTH, CHUNK, False,
                               kw["stochastic"], seed, kw["light_sampler"])
            for seed in (0, 1, *SEEDS, -1, 2**40 + 3)}
    assert len(keys) == 1


@pytest.mark.parametrize("mode", ["stochastic", "sampler", "both"])
def test_seeds_a_b_a_share_one_entry(mode):
    """A miss at a, hits at b and a again: one entry all along, each call
    its own seed's eager frame (a's twice, b's another), ``seed_new`` 0, 1,
    1; a repeat of a is a hit with ``seed_new`` 0. (The area hair frame
    takes the same path on the card; its plain walk is slow here.)"""
    ts, meta, kw = _case("area_mirror", "cpu", mode != "sampler",
                         mode != "stochastic")
    renderer._frames.clear()
    a, b = SEEDS
    served = _served(ts, meta, (a, b, a, a), **kw)
    (state,) = renderer._frames.values()
    assert [hit for _, hit, _ in served] == [False, True, True, True]
    assert [new for _, _, new in served] == [0, 1, 1, 0]
    assert state.last_seed == a
    want = {s: renderer.frame_eager(ts, meta, W, H, SAMPLES, seed=s, **kw)
            for s in (a, b)}
    for (got, _, _), seed in zip(served, (a, b, a, a)):
        assert np.array_equal(_bits(got), _bits(want[seed]))
    assert not np.array_equal(_bits(want[a]), _bits(want[b]))
    assert len(renderer._frames) == 1


@pytest.mark.parametrize("seed", [0, 7, 2**31, 2**32 - 1, -1, 2**33 + 7])
def test_seed_word_holds_the_seed_bits(seed):
    """The staged word's i32 holds ``seed & 0xFFFFFFFF``; a seed that agrees
    in its low 32 bits gives the same frame."""
    ts, meta, kw = _case("area_mirror", "cpu", sampler=False)
    renderer._frames.clear()
    got = renderer.frame_device(ts, meta, W, H, SAMPLES, seed=seed, **kw)
    got = got[:W * H].numpy().copy()
    (state,) = renderer._frames.values()
    word = int(state.seed_word)
    assert word == camera.seed_word_value(seed)
    assert np.int64(word) & 0xFFFFFFFF == seed & 0xFFFFFFFF
    assert state.host_seed() == seed & 0xFFFFFFFF
    want = renderer.frame_eager(ts, meta, W, H, SAMPLES,
                                seed=seed & 0xFFFFFFFF, **kw)
    assert np.array_equal(_bits(got), _bits(want))


def test_seed_arguments_of_k7_and_k8():
    """An int seed goes by value (its 32 bits) with no word; a (1,) i32
    tensor goes by pointer; another dtype or shape is refused."""
    assert camera._seed_args(2**32 + 5, torch.device("cpu")) == (5, None)
    word = torch.tensor([camera.seed_word_value(2**32 - 2)],
                        dtype=torch.int32)
    value, ptr = camera._seed_args(word, word.device)
    assert value == 0 and ptr.value == word.data_ptr()
    for bad in (word.long(), torch.zeros(2, dtype=torch.int32)):
        with pytest.raises((TypeError, ValueError)):
            camera._seed_args(bad, word.device)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

# 160 x 90 at 2 x 2 samples, chunks of 2,000 pixels: 7 whole and a tail
CW, CH, CCHUNK = 160, 90, 2000


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HOSTS))
def test_card_seeds_a_b_a_share_one_graph(cuda_device, name):
    """Seeds a, b, a through the kept CUDA graph: one entry and one capture
    (the hits keep its graph and capture nothing), each call its seed's
    ``frame_eager`` bits, f32 sums and u8."""
    ts, meta, kw = _case(name, cuda_device)
    kw["chunk_pixels"] = CCHUNK
    a, b = SEEDS
    for ldr in (False, True):
        renderer._frames.clear()
        served = _served(ts, meta, (a, b, a), CW, CH, ldr=ldr, **kw)
        (state,) = renderer._frames.values()
        graph = state.graph
        captures = []
        for seed in (b, a):
            renderer.frame_device(ts, meta, CW, CH, SAMPLES, seed=seed,
                                  ldr=ldr, **kw)
            captures.append(kernels.last_frame()["host_ms"]["capture"])
        assert captures == [0.0, 0.0]
        assert renderer._frames[next(iter(renderer._frames))] is state
        assert state.graph is graph
        assert [hit for _, hit, _ in served] == [False, True, True]
        assert [new for _, _, new in served] == [0, 1, 1]
        for (got, _, _), seed in zip(served, (a, b, a)):
            want = renderer.frame_eager(ts, meta, CW, CH, SAMPLES, seed=seed,
                                        ldr=ldr, **kw)
            assert np.array_equal(_bits(got), _bits(want)), (ldr, seed)
        assert not np.array_equal(served[0][0], served[1][0])

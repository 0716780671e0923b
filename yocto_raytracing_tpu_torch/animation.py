"""Keyframe animation playback.

This package's own copy of ``yocto_raytracing_tpu/animation.py`` (numpy
only, results unchanged). Parity: the reference's animation utilities
(src/scene.h:90-95 `animation`, src/scene.cpp:35-49
`update_animation`/`add_keyframe`) — dead code there (no caller anywhere
in the app), implemented here for capability parity, plus the tracks
stacked for a batch of times.

The reference semantics, kept exactly:

* an animation stores ``delta_t`` (default 1/60) plus parallel keyframe
  tracks: instance frames, and optionally full vertex position / normal
  arrays (vertex-cache animation);
* playback picks ``idx = int(time / delta_t) % num_keyframes`` — stepwise,
  no interpolation (src/scene.cpp:38);
* ``add_keyframe`` snapshots the instance's current frame + its shape's
  pos/norm onto the tracks (src/scene.cpp:45-49).

glTF animation import (linear/step/cubicspline samplers over node TRS) is
separate — see io/gltf.py ``sample_channel`` /
``update_animated_transforms``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Animation:
    """Keyframe tracks (src/scene.h:90-95).

    ``frame_axes``/``frame_o`` are the frame3f keyframes split into our
    axes/origin convention; pos/norm tracks are full per-keyframe vertex
    arrays (empty list = track absent, like the reference's empty vector).
    """

    delta_t: float = 1.0 / 60.0
    frame_axes: list = field(default_factory=list)   # [(3, 3) f32]
    frame_o: list = field(default_factory=list)      # [(3,) f32]
    pos_keyframes: list = field(default_factory=list)   # [(V, 3) f32]
    norm_keyframes: list = field(default_factory=list)  # [(V, 3) f32]

    @property
    def num_keyframes(self) -> int:
        return len(self.frame_axes)


def keyframe_index(time, delta_t: float, num_keyframes: int):
    """The reference's stepwise playback index (src/scene.cpp:38):
    ``int(time / delta_t) % n``. Works on scalars or numpy arrays; C int
    truncation (toward zero) semantics."""
    idx = np.trunc(np.asarray(time, np.float32) / np.float32(delta_t))
    return idx.astype(np.int64) % num_keyframes


def update_animation(host, inst_id: int, anim: Animation, time: float) -> None:
    """Apply ``anim`` at ``time`` to instance ``inst_id`` of a HostScene.

    Parity: update_animation (src/scene.cpp:35-43) — sets the instance
    frame from the keyframe track and, when vertex tracks exist, replaces
    the shape's pos/norm arrays in place. Re-run build_device_scene
    afterwards (geometry changed, the BVH must be rebuilt — the reference
    has the same obligation on its per-shape BVHs, it just never
    animates).
    """
    if anim.num_keyframes == 0:
        return
    idx = int(keyframe_index(time, anim.delta_t, anim.num_keyframes))
    ist = host.instances[inst_id]
    ist.axes = np.asarray(anim.frame_axes[idx], np.float32)
    ist.o = np.asarray(anim.frame_o[idx], np.float32)
    shp = host.shapes[ist.shape]
    if anim.pos_keyframes:
        shp.pos = np.asarray(anim.pos_keyframes[idx], np.float32)
    if anim.norm_keyframes:
        shp.norm = np.asarray(anim.norm_keyframes[idx], np.float32)


def add_keyframe(host, inst_id: int, anim: Animation) -> None:
    """Snapshot the instance's current frame + shape pos/norm as a new
    keyframe (parity: add_keyframe, src/scene.cpp:45-49)."""
    ist = host.instances[inst_id]
    shp = host.shapes[ist.shape]
    anim.frame_axes.append(np.array(ist.axes, np.float32))
    anim.frame_o.append(np.array(ist.o, np.float32))
    anim.pos_keyframes.append(np.array(shp.pos, np.float32))
    anim.norm_keyframes.append(np.array(shp.norm, np.float32))


def stack_tracks(anim: Animation):
    """Keyframe tracks as stacked arrays.

    Returns (axes (K, 3, 3), o (K, 3), pos (K, V, 3) | None,
    norm (K, V, 3) | None): a whole batch of times maps to frames by one
    gather, ``axes[keyframe_index(times, dt, K)]``.
    """
    axes = np.stack(anim.frame_axes).astype(np.float32)
    o = np.stack(anim.frame_o).astype(np.float32)
    pos = (np.stack(anim.pos_keyframes).astype(np.float32)
           if anim.pos_keyframes else None)
    norm = (np.stack(anim.norm_keyframes).astype(np.float32)
            if anim.norm_keyframes else None)
    return axes, o, pos, norm

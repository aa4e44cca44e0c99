"""Stackless threaded-BVH traversal in plain JAX (dense ray batches): the
cascade.

A replacement for the reference's 64-entry per-thread stack traversal
(bvh.h:118-161 ``CachedBVH::intersect``, bvh.h:213-256
``intersectSimple``) written as array operations.  Per-ray state is a
single node index; the next node is a table lookup into precomputed
per-octant hit/miss links (:func:`tyrant_tpu.scene.bvh.thread_links`), so
the whole batch advances in lock-step ``lax.while_loop`` iterations of
dense gathers + slab tests — no per-lane stack.

  * One 32-byte packed node row per visit ([Nn, 8] f32 with meta/child
    bitcast into lanes) — the same cache-line layout as the reference's
    ``static_assert(sizeof(BVHNode)==32)`` (bvh.h:68).
  * Leaf triangles are packed LEAF_WIDTH-per-row ([L, 9*LEAF_WIDTH]) so a
    leaf visit gathers ONE row; leaf work runs under ``lax.cond`` so
    iterations where no ray in the batch sits at a leaf skip the gather.
  * Rays are processed in CHUNK-sized chunks via ``lax.map`` so each
    chunk's while_loop trip count adapts to ITS worst ray instead of the
    whole batch's.

Ordered near-child-first traversal (the reference's ``dirIsNeg[splitAxis]``
trick, bvh.h:146-152) is preserved exactly: links are indexed by the ray's
direction octant.  Early-out pruning against the current closest hit
(Bbox.h:61) carries over unchanged.

This is the traversal on every platform but NVIDIA GPUs, where the CUDA
kernels of :mod:`tyrant_tpu.ops.cuda` run instead
(:func:`traversal_for`), and it is the semantic oracle for those kernels.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import EPSILON, VERY_FAR
from ..scene.bvh import META_AXIS_MASK, META_AXIS_SHIFT, META_COUNT_MASK, META_OFFSET_SHIFT
from .intersect import moller_trumbore

LEAF_WIDTH = 6  # == BVHConfig.max_prims_per_leaf (reference uses 4, bvh.h:78)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BVHDevice:
    """Device-resident BVH + triangle SoA (all jnp arrays).

    Mirrors the reference's ``CachedBVH`` (bvh.h:111-116): raw node and
    primitive buffers uploaded once at scene load (Scene.cpp:55-65).

    node_packed: [Nn, 8] f32 — lo.xyz, hi.xyz, meta (bitcast i32),
        second_child (bitcast i32).  32 bytes, like the reference node.
    miss_flat: [8 * Nn] i32 — per-octant escape links, octant-major.
    tri_packed: [T + pad, 12] f32 — v0.xyz, e1.xyz, e2.xyz, pad.  Leaf
        order, padded with degenerate rows so leaf reads stay in bounds.
    """

    node_packed: jnp.ndarray
    miss_flat: jnp.ndarray
    tri_packed: jnp.ndarray
    leaf_packed: jnp.ndarray  # [L, 9*LEAF_WIDTH] f32 tri slots (v0,e1,e2)

    def tree_flatten(self):
        return ((self.node_packed, self.miss_flat, self.tri_packed,
                 self.leaf_packed), None)

    @classmethod
    def tree_unflatten(cls, aux, fields):
        return cls(*fields)

    @property
    def n_nodes(self):
        return self.node_packed.shape[0]

    # triangle SoA views (leaf order) for shading
    @property
    def tri_vert(self):
        return self.tri_packed[:, 0:3]

    @property
    def tri_e1(self):
        return self.tri_packed[:, 3:6]

    @property
    def tri_e2(self):
        return self.tri_packed[:, 6:9]

    @classmethod
    def from_host(cls, bvh, tri_vert, tri_e1, tri_e2):
        """bvh: scene.bvh.BVHArrays; tri_*: [T,3] in ORIGINAL order (will be
        permuted to leaf order and padded here)."""
        import numpy as np
        nn = bvh.n_nodes
        count = bvh.prim_count
        offset = bvh.prim_offset
        is_leaf = count > 0

        perm = bvh.perm
        t = perm.shape[0]
        tri = np.zeros((t + LEAF_WIDTH - 1, 12), np.float32)
        tri[:t, 0:3] = tri_vert[perm]
        tri[:t, 3:6] = tri_e1[perm]
        tri[:t, 6:9] = tri_e2[perm]

        # leaf-major packed rows: [L, 9*LEAF_WIDTH], so a leaf visit gathers
        # ONE row.  Empty slots point at a degenerate triangle.
        leaf_ids = np.nonzero(is_leaf)[0]
        n_leaves = max(len(leaf_ids), 1)
        tri9 = np.concatenate([tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]], axis=1)
        tri9 = np.vstack([tri9, np.zeros((1, 9), np.float32)])
        slot = offset[leaf_ids][:, None] + np.arange(LEAF_WIDTH)[None]
        slot = np.where(np.arange(LEAF_WIDTH)[None] < count[leaf_ids][:, None],
                        slot, tri9.shape[0] - 1)
        leaf_packed = tri9[slot].reshape(len(leaf_ids), 9 * LEAF_WIDTH) \
            if len(leaf_ids) else np.zeros((1, 9 * LEAF_WIDTH), np.float32)

        # node lane 7: second child for interiors, leaf-row index for leaves
        leaf_row = np.zeros(nn, np.int32)
        leaf_row[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
        lane7 = np.where(is_leaf, leaf_row, bvh.second_child).astype(np.int32)

        node = np.zeros((nn, 8), np.float32)
        node[:, 0:3] = bvh.lo
        node[:, 3:6] = bvh.hi
        node[:, 6] = bvh.meta.view(np.float32)
        node[:, 7] = lane7.view(np.float32)
        return cls(node_packed=jnp.asarray(node),
                   miss_flat=jnp.asarray(bvh.miss_link.reshape(-1)),
                   tri_packed=jnp.asarray(tri),
                   leaf_packed=jnp.asarray(leaf_packed))


def _ray_setup(direction):
    inv_dir = 1.0 / direction
    neg = direction < 0.0
    octant = (neg[:, 0].astype(jnp.int32)
              + 2 * neg[:, 1].astype(jnp.int32)
              + 4 * neg[:, 2].astype(jnp.int32))
    return inv_dir, neg, octant


def _step(bvh: BVHDevice, origin, direction, inv_dir, neg, octant,
          node, t_best, hit_id, closest: bool, t_limit=None):
    """One traversal visit, usable both trace-time-unrolled and inside
    lax.while bodies.  Gathers exactly two rows per active ray: the packed
    32-byte node and (for leaves) the packed 144-byte leaf-triangle row.

    closest=True: (t_best, hit_id) = running closest hit.
    closest=False: hit_id is the occluded flag (0/1), t_limit the max dist.
    """
    ni = jnp.maximum(node, 0)
    active = node >= 0
    row = bvh.node_packed[ni]
    lo, hi = row[:, 0:3], row[:, 3:6]
    meta = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
    lane7 = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
    count = meta & META_COUNT_MASK
    axis = (meta >> META_AXIS_SHIFT) & META_AXIS_MASK
    offset = meta >> META_OFFSET_SHIFT

    near_b = jnp.where(neg, hi, lo)
    far_b = jnp.where(neg, lo, hi)
    t0 = jnp.max((near_b - origin) * inv_dir, axis=-1)
    t1 = jnp.min((far_b - origin) * inv_dir, axis=-1)
    prune = t_best if closest else t_limit
    box_hit = (t0 <= t1) & (t0 < prune) & (t1 > 0) & active

    is_leaf = count > 0
    do_leaf = box_hit & is_leaf

    # --- leaf: one packed row, LEAF_WIDTH unrolled slots (bvh.h:131-139) ---
    lrow = bvh.leaf_packed[jnp.where(is_leaf, lane7, 0)]
    slot_idx = jnp.arange(LEAF_WIDTH, dtype=jnp.int32)[None]
    tv = lrow.reshape(-1, LEAF_WIDTH, 9)
    t4 = moller_trumbore(origin[:, None, :], direction[:, None, :],
                         tv[..., 0:3], tv[..., 3:6], tv[..., 6:9])
    limit_col = (t_best if closest else t_limit)[:, None]
    ok = (t4 > EPSILON) & ((limit_col - t4) > EPSILON) \
        & (slot_idx < count[:, None]) & do_leaf[:, None]
    if closest:
        t4m = jnp.where(ok, t4, VERY_FAR)
        j = jnp.argmin(t4m, axis=1)
        t_min = jnp.min(t4m, axis=1)
        upd = t_min < t_best
        t_best = jnp.where(upd, t_min, t_best)
        hit_id = jnp.where(upd, offset + j, hit_id)
    else:
        hit_id = hit_id | jnp.any(ok, axis=1).astype(jnp.int32)

    # --- next node via threaded links (bvh.h:146-152 ordering) ---
    axis_neg = jnp.take_along_axis(neg.astype(jnp.int32), axis[:, None],
                                   axis=1)[:, 0]
    near = jnp.where(axis_neg == 1, lane7, ni + 1)  # lane7 = second child
    miss = bvh.miss_flat[octant * bvh.n_nodes + ni]
    nxt = jnp.where(box_hit & ~is_leaf, near, miss)
    if not closest:
        nxt = jnp.where(hit_id > 0, -1, nxt)  # any-hit early exit
    node = jnp.where(active, nxt, node)
    return node, t_best, hit_id


def _node_step(bvh: BVHDevice, origin, inv_dir, neg, octant, node, t_prune):
    """Box test + threaded-link advance (no leaf work).  One 32-byte row
    gather per active ray."""
    ni = jnp.maximum(node, 0)
    active = node >= 0
    row = bvh.node_packed[ni]
    lo, hi = row[:, 0:3], row[:, 3:6]
    meta = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
    lane7 = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
    count = meta & META_COUNT_MASK
    axis = (meta >> META_AXIS_SHIFT) & META_AXIS_MASK
    offset = meta >> META_OFFSET_SHIFT

    near_b = jnp.where(neg, hi, lo)
    far_b = jnp.where(neg, lo, hi)
    t0 = jnp.max((near_b - origin) * inv_dir, axis=-1)
    t1 = jnp.min((far_b - origin) * inv_dir, axis=-1)
    box_hit = (t0 <= t1) & (t0 < t_prune) & (t1 > 0) & active

    is_leaf = count > 0
    axis_neg = jnp.take_along_axis(neg.astype(jnp.int32), axis[:, None],
                                   axis=1)[:, 0]
    near = jnp.where(axis_neg == 1, lane7, ni + 1)
    miss = bvh.miss_flat[octant * bvh.n_nodes + ni]
    nxt = jnp.where(box_hit & ~is_leaf, near, miss)
    nxt = jnp.where(active, nxt, node)
    do_leaf = box_hit & is_leaf
    return do_leaf, lane7, offset, count, nxt


def _leaf_tests(bvh, origin, direction, do_leaf, leaf_row, offset, count,
                limit_t):
    """One packed leaf-row gather + LEAF_WIDTH unrolled Möller-Trumbore slots.
    Returns (t4m [N,4] masked distances, ids [N,4])."""
    lrow = bvh.leaf_packed[jnp.where(do_leaf, leaf_row, 0)]
    tv = lrow.reshape(-1, LEAF_WIDTH, 9)
    t4 = moller_trumbore(origin[:, None, :], direction[:, None, :],
                         tv[..., 0:3], tv[..., 3:6], tv[..., 6:9])
    slot = jnp.arange(LEAF_WIDTH, dtype=jnp.int32)[None]
    ok = (t4 > EPSILON) & ((limit_t[:, None] - t4) > EPSILON) \
        & (slot < count[:, None]) & do_leaf[:, None]
    return jnp.where(ok, t4, VERY_FAR), offset[:, None] + slot


def _chunk_closest(origin, direction, t_init, bvh: BVHDevice):
    """Closest hit for one chunk: while_loop with lax.cond-gated leaf work
    (iterations where no ray in the chunk sits at a leaf skip the leaf
    gather entirely)."""
    n = origin.shape[0]
    inv_dir, neg, octant = _ray_setup(direction)

    def cond(s):
        return jnp.any(s[0] >= 0)

    def body(s):
        node, t_best, hit_id = s
        do_leaf, leaf_row, offset, count, nxt = _node_step(
            bvh, origin, inv_dir, neg, octant, node, t_best)

        def leaf(args):
            t_best, hit_id = args
            t4m, ids = _leaf_tests(bvh, origin, direction, do_leaf, leaf_row,
                                   offset, count, t_best)
            j = jnp.argmin(t4m, axis=1)
            t_min = jnp.min(t4m, axis=1)
            upd = t_min < t_best
            t_best = jnp.where(upd, t_min, t_best)
            hit_id = jnp.where(
                upd, jnp.take_along_axis(ids, j[:, None], 1)[:, 0], hit_id)
            return t_best, hit_id

        t_best, hit_id = jax.lax.cond(jnp.any(do_leaf), leaf, lambda a: a,
                                      (t_best, hit_id))
        return nxt, t_best, hit_id

    # carries derive from the (possibly shard_map-varying) inputs rather
    # than literals, so the lax.cond branches agree on varying manual axes
    # under shard_map's check_vma (a literal-seeded carry makes the
    # pass-through branch device-invariant while the leaf branch is
    # varying: "varying manual axes do not match" at this cond)
    zero = (origin[:, 0] * 0.0).astype(jnp.int32)
    state = (zero, t_init, zero - 1)
    _, t, hit_id = jax.lax.while_loop(cond, body, state)
    return t, hit_id


def _chunk_any(origin, direction, max_dist, node0, bvh: BVHDevice):
    n = origin.shape[0]
    inv_dir, neg, octant = _ray_setup(direction)

    def cond(s):
        return jnp.any(s[0] >= 0)

    def body(s):
        node, occ = s
        do_leaf, leaf_row, offset, count, nxt = _node_step(
            bvh, origin, inv_dir, neg, octant, node, max_dist)

        def leaf(occ):
            t4m, _ = _leaf_tests(bvh, origin, direction, do_leaf, leaf_row,
                                 offset, count, max_dist)
            return occ | jnp.any(t4m < VERY_FAR, axis=1)

        occ = jax.lax.cond(jnp.any(do_leaf), leaf, lambda o: o, occ)
        nxt = jnp.where(occ, -1, nxt)  # first hit terminates (bvh.h:231)
        return nxt, occ

    state = (node0, node0 < -1)  # all-False occ, derived (see _chunk_closest)
    _, occ = jax.lax.while_loop(cond, body, state)
    return occ


# Rays per lax.map chunk: a chunk's while_loop trip count adapts to ITS
# worst ray.
CHUNK = 16384


def _map_chunks(fn, arrays, n):
    chunk = CHUNK
    if n > chunk and n % chunk == 0:
        c = n // chunk
        reshaped = tuple(a.reshape((c, chunk) + a.shape[1:]) for a in arrays)
        out = jax.lax.map(lambda xs: fn(*xs), reshaped)
        return jax.tree.map(lambda o: o.reshape((n,) + o.shape[2:]), out)
    return fn(*arrays)


@jax.jit
def closest_hit(origin, direction, bvh: BVHDevice, t_init=None):
    """Closest-hit traversal.  Reference: bvh.h:118-161.

    origin/direction: [N, 3].  t_init: optional [N] initial closest distance
    (the reference seeds traversal with the sphere-pass result,
    kernel.cu:125-141).  Returns (t [N], prim_id [N]) with t == t_init (or
    VERY_FAR) and prim_id == -1 on miss.
    """
    n = origin.shape[0]
    if t_init is None:
        t_init = origin[:, 0] * 0.0 + VERY_FAR  # derived, not a literal
    return _map_chunks(lambda o, d, t: _chunk_closest(o, d, t, bvh),
                       (origin, direction, t_init), n)


@jax.jit
def any_hit(origin, direction, max_dist, bvh: BVHDevice, active=None):
    """Shadow-ray occlusion test.  Reference: bvh.h:213-256
    ``intersectSimple`` — accepts any t > eps with (maxDist - t) > eps and
    terminates that ray immediately.

    ``active``: optional [N] bool — inactive rays skip traversal entirely
    (the dense-batch stand-in for the reference's shadow_ray_cnt-bounded
    loop, kernel.cu:634).  Returns occluded [N] bool.
    """
    n = origin.shape[0]
    if active is None:
        node0 = (origin[:, 0] * 0.0).astype(jnp.int32)  # derived literal 0
    else:
        node0 = jnp.where(active, 0, -1).astype(jnp.int32)
    return _map_chunks(lambda o, d, m, s: _chunk_any(o, d, m, s, bvh),
                       (origin, direction, max_dist, node0), n)


def traversal_depth_map(origin, direction, bvh: BVHDevice):
    """BVH-quality heatmap: node visits per ray (the reference's BVH_DEBUG
    mode, kernel.cu:300-328 / bvh.h:164-209).  Lock-step (diagnostics only).
    Returns (t, prim_id, visits)."""
    n = origin.shape[0]
    inv_dir, neg, octant = _ray_setup(direction)

    def cond(s):
        return jnp.any(s[0][0] >= 0)

    def body(s):
        state, visits = s
        visits = visits + (state[0] >= 0).astype(jnp.int32)
        state = _step(bvh, origin, direction, inv_dir, neg, octant, *state,
                      closest=True)
        return state, visits

    state0 = ((jnp.zeros((n,), jnp.int32),
               jnp.full((n,), VERY_FAR, jnp.float32),
               jnp.full((n,), -1, jnp.int32)),
              jnp.zeros((n,), jnp.int32))
    (node, t, hit_id), visits = jax.lax.while_loop(cond, body, state0)
    return t, hit_id, visits


def traversal_for(devices) -> str:
    """The one place the BVH traversal is chosen, from the platform of the
    devices a step runs on: "cuda" (the kernels of :mod:`tyrant_tpu.ops.cuda`)
    on NVIDIA GPUs, "xla" (this module's cascade) on every other platform."""
    return "cuda" if devices[0].platform == "gpu" else "xla"

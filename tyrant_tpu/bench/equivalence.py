"""The traversal kernels against the cascade, on the rays of the benchmark's
equivalence gate.

Half the rays start anywhere in (and around) the scene box with random
directions (bounce-like: incoherent origins and directions); half aim into
the middle of the box (hit-heavy, leaf-dominated).  The limits:

  * closest-hit ids exact, except ties: two triangles whose distances from
    the ray agree within EPSILON, where the accept rule
    ``(t_best - t) > EPSILON`` (bvh.h:134) may take either;
  * closest-hit distances within ``rtol=1e-4``;
  * occlusion exact.

The kernels and the cascade run the same operations in the same order, so
what they may differ in is floating-point contraction (the CUDA compiler
and XLA each fuse multiply-adds where they choose): last-bit differences
of ``t``, which can swap the winner of a near-tie and, rarely, flip an
accept test that sits exactly on its threshold.
"""

from __future__ import annotations

import numpy as np

from ..config import EPSILON

T_RTOL = 1e-4


def gate_rays(bvh, n_rays: int, seed: int = 2024):
    """[n_rays, 3] origins and unit directions (numpy f32)."""
    r = np.random.default_rng(seed)
    node = np.asarray(bvh.node_packed)
    lo, hi = node[0, 0:3], node[0, 3:6]
    o = (lo + (hi - lo) * r.uniform(-0.2, 1.2, (n_rays, 3))).astype(np.float32)
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    half = n_rays // 2
    tgt = lo + (hi - lo) * r.uniform(0.2, 0.8, (n_rays - half, 3))
    d2 = (tgt - o[half:]).astype(np.float32)
    d[half:] = d2 / np.linalg.norm(d2, axis=1, keepdims=True)
    return o, d


def compare_closest(t_ref, id_ref, t_k, id_k) -> dict:
    """Counts of closest-hit disagreements beyond the limits above."""
    t_ref, id_ref = np.asarray(t_ref), np.asarray(id_ref)
    t_k, id_k = np.asarray(t_k), np.asarray(id_k)
    tie = np.abs(t_ref - t_k) <= EPSILON
    id_bad = (id_ref != id_k) & ~tie
    t_bad = ~np.isclose(t_k, t_ref, rtol=T_RTOL, atol=0.0)
    return {"rays": int(t_ref.size), "hits": int((id_ref >= 0).sum()),
            "id_ties": int(((id_ref != id_k) & tie).sum()),
            "id_bad": int(id_bad.sum()), "t_bad": int(t_bad.sum())}


def compare_any(occ_ref, occ_k) -> dict:
    occ_ref, occ_k = np.asarray(occ_ref), np.asarray(occ_k)
    return {"occluded": int(occ_ref.sum()),
            "occ_bad": int((occ_ref != occ_k).sum())}


def check_kernels(bvh, n_rays: int = 65_536, seed: int = 2024) -> dict:
    """Run the CUDA kernels (ops/cuda) and the cascade (ops/traverse) on the
    gate rays: closest hit without and with ``t_init``; any hit with
    ``max_dist`` just past the closest hit or just short of it (the scene's
    extent for misses) and every fourth ray inactive.  Returns the counts
    and ``ok``."""
    import jax.numpy as jnp

    from ..ops import cuda, traverse

    o, d = gate_rays(bvh, n_rays, seed)
    o, d = jnp.asarray(o), jnp.asarray(d)
    out = {}
    t_ref, id_ref = traverse.closest_hit(o, d, bvh)
    out["closest"] = compare_closest(t_ref, id_ref,
                                     *cuda.closest_hit(o, d, bvh))
    t_np, id_np = np.asarray(t_ref), np.asarray(id_ref)
    hits = id_np >= 0
    node = np.asarray(bvh.node_packed)
    extent = float((node[0, 3:6] - node[0, 0:3]).max())
    # seeds (the sphere pass's distance in a render) just beyond a ray's
    # hit, just short of it, or absent: the kernel must keep or beat them
    scale = np.where(np.arange(n_rays) % 3 == 0, 0.99, 1.01)
    seeded = hits & (np.arange(n_rays) % 2 == 0)
    t_init = jnp.asarray(np.where(seeded, t_np * scale,
                                  1e20).astype(np.float32))
    out["closest_t_init"] = compare_closest(
        *traverse.closest_hit(o, d, bvh, t_init=t_init),
        *cuda.closest_hit(o, d, bvh, t_init=t_init))
    # shadow rays ending past their closest hit (occluded) or short of it
    maxd = jnp.asarray(np.where(hits, t_np * scale,
                                extent).astype(np.float32))
    active = jnp.asarray(np.arange(n_rays) % 4 != 3)
    out["any"] = compare_any(
        traverse.any_hit(o, d, maxd, bvh, active=active),
        cuda.any_hit(o, d, maxd, bvh, active=active))
    out["ok"] = (all(out[k]["id_bad"] == 0 and out[k]["t_bad"] == 0
                     for k in ("closest", "closest_t_init"))
                 and out["any"]["occ_bad"] == 0)
    return out

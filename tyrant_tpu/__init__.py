"""tyrant_tpu — a wavefront Monte-Carlo path tracer in JAX.

A JAX rebuild of the capabilities of the CUDA renderer stijnherfst/Tyrant
(see SURVEY.md), with CUDA BVH traversal kernels on NVIDIA GPUs
(ops/cuda): progressive interactive path tracing with
a binned-SAH BVH, five BSDFs, next-event estimation against a dynamic sun/sky
atmosphere and an area light, Russian-roulette path termination, depth of
field, stratified sampling, and cross-step path continuation — expressed as
dense fixed-shape ray batches instead of atomic work-stealing queues, and
scaled across chips with ``shard_map`` instead of staying single-GPU.
"""

from .config import BVHConfig, RenderConfig, SkyConfig, small_config  # noqa: F401

__version__ = "0.1.0"

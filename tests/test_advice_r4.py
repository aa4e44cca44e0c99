"""Review fixes pinned by tests: auto-exposure on black buffers, fog
falloff validation and related edge cases."""

import dataclasses
import math

import numpy as np
import pytest


def test_auto_exposure_black_buffer_stays_black():
    """A near-black radiance buffer returns exposure 1.0 instead of the
    key/eps ~1.8e5 gain that amplified residual noise."""
    from tyrant_tpu.ops.tonemap import auto_exposure
    assert auto_exposure(np.zeros((8, 8, 3), np.float32)) == 1.0
    assert auto_exposure(np.full((8, 8, 3), 1e-9, np.float32)) == 1.0
    # a normally lit buffer still returns the photographic key
    ex = auto_exposure(np.full((8, 8, 3), 0.5, np.float32))
    assert 0.2 < ex < 1.0


def test_fog_falloff_clamp_validity_gate():
    """Configs whose dense slab end exceeds the +-60 density-exponent
    clamp are rejected (the closed form would silently saturate)."""
    from tyrant_tpu.config import small_config
    # passes the old -1e6 gate but exceeds the clamp: falloff*1e5 >> 60
    with pytest.raises(ValueError, match="exponent clamp"):
        dataclasses.replace(small_config(), fog="on", fog_falloff=0.05,
                            fog_z_min=-1e5)
    # negative falloff: the dense end is the ceiling
    with pytest.raises(ValueError, match="exponent clamp"):
        dataclasses.replace(small_config(), fog="on", fog_falloff=-0.05,
                            fog_z_max=1e5, fog_z_min=0.0)
    # inside the validity range: accepted
    dataclasses.replace(small_config(), fog="on", fog_falloff=0.05,
                        fog_z_min=-100.0)
    dataclasses.replace(small_config(), fog="on", fog_falloff=0.05,
                        fog_z_min=0.0)

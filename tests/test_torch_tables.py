"""The port's host tables equal the JAX package's, as integers.

``tables_from_reference`` carries the reference's radix-12 G tables
(``bdls_tpu.ops.verify_fold.const_tree``) into the port's
``(256, 3, 8)`` uint32 layout; the port's own ``g_table_8bit`` must hold
exactly the same integers, entry 0 = (0 : 1 : 0) included. The device
copy is the same table in Montgomery form.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bdls_tpu.ops import verify_fold as jvf
from bdls_tpu.ops.curves import CURVES as JCURVES
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.ops.curves import CURVES


@pytest.mark.parametrize("name", sorted(CURVES))
def test_g_table_equals_reference(name):
    ref = vf.tables_from_reference(
        {k: np.asarray(v) for k, v in jvf.const_tree(JCURVES[name]).items()})
    own = vf.g_table_8bit(name)
    assert set(ref) == {name}
    assert ref[name].dtype == own.dtype == np.uint32
    assert ref[name].shape == own.shape == (256, 3, 8)
    assert np.array_equal(ref[name], own)
    ints = vf.table_ints(own)
    assert ints[0] == [0, 1, 0]
    cv = CURVES[name]
    assert ints[1] == [cv.gx, cv.gy, 1]


@pytest.mark.parametrize("name", sorted(CURVES))
def test_device_table_is_montgomery_form(name):
    p = CURVES[name].fp.modulus
    dev = vf.device_g_table(name, torch.device("cpu")).numpy().view(np.uint32)
    for plain, mont in zip(vf.table_ints(vf.g_table_8bit(name)),
                           vf.table_ints(dev)):
        assert mont == [v * (1 << 256) % p for v in plain]

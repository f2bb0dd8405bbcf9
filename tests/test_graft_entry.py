"""The driver entry points must stay importable and runnable."""
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ge = pytest.importorskip(
    '__graft_entry__',
    reason='driver entry lives in the source tree, not the wheel')


class TestEntry:
    def test_forward_compiles(self):
        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        assert len(out) == 3
        for o in out:
            assert np.isfinite(np.asarray(o)).all()

    def test_dryrun_multichip(self):
        if len(jax.devices()) < 8:
            pytest.skip('needs 8 devices')
        ge.dryrun_multichip(8)

    def test_dryrun_multichip_odd(self):
        if len(jax.devices()) < 4:
            pytest.skip('needs 4 devices')
        ge.dryrun_multichip(4)

"""K6's wrapper keeps the data of the last (x, y, sigma) it served; that
entry must die with x or y (the JAX package caches nothing between calls,
``brancher_tpu/ops/pallas_logreg.py``)."""
import gc
import weakref

import pytest
import torch

import brancher_torch.ops.logreg as TLR


class _Sentinel:
    """A weakly referenceable stand-in for the family's scratch."""


def _stand_in_logreg_data(built):
    real = TLR.logreg_data

    def build(x, y, prior_scale):
        fam = real(x, y, prior_scale)._replace(x=x, y=y, scratch=_Sentinel())
        built.append(weakref.ref(fam.scratch))
        return fam
    return build


@pytest.mark.parametrize("drop", ["x", "y", "both"])
def test_cache_dies_with_x_or_y(monkeypatch, drop):
    """A family that holds x and y themselves (the worst case) is freed once
    the caller drops x or y and the collector runs."""
    built = []
    monkeypatch.setattr(TLR, "logreg_data", _stand_in_logreg_data(built))
    cache = TLR._LastData()
    x, y = torch.randn(6, 32), torch.ones(6)
    fam = cache.get(x, y, 1.0)
    assert cache.get(x, y, 1.0) is fam and len(built) == 1
    assert fam.x is not x and fam.x.data_ptr() == x.data_ptr()  # same memory, no copy
    del fam
    if drop in ("x", "both"):
        del x
    if drop in ("y", "both"):
        del y
    gc.collect()
    assert built[0]() is None
    assert cache.data is None and cache.key is None


@pytest.mark.parametrize("d", [32, 33])
def test_module_cache_frees_x_copy_and_scratch(d):
    """The module-level cache with the real logreg_data: where X's rows are not
    128 bytes apart (a ragged D, or memory not so aligned) the family holds
    an aligned copy of X, which goes with x."""
    x, y = torch.randn(5, d), torch.zeros(5)
    fam = TLR._LAST.get(x, y, 2.0)
    copy_ref = weakref.ref(fam.x)
    x_ref = weakref.ref(x)
    del fam, x
    gc.collect()
    assert x_ref() is None and copy_ref() is None
    assert TLR._LAST.data is None

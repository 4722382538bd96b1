"""Embedded-interpreter glue behind the port's linkable C ABI (the JAX
package's ``c_embed.py``).

``csrc/c_api_embed.cpp`` hosts a CPython interpreter and forwards each
``LGBM_*`` export (reference: src/c_api.cpp:47-1568,
include/LightGBM/c_api.h) to a function here. The C side passes raw
buffer addresses as integers; this module wraps them zero-copy with
numpy/ctypes, calls the port's C-API shim (``capi.py``, the engine the
Python package uses), and writes results straight back into the caller's
preallocated buffers.

Handles are small integers into a registry (not PyObject pointers), so
the C side never touches refcounts. Freeing a handle frees what it holds
(``LGBM_DatasetFree`` / ``LGBM_BoosterFree``: the binned set's and the
booster's device tensors, its stacked forest and its step-cache pool),
not only the registry slot.

The device: the C signatures are fixed, so it cannot come through them.
It comes from ``LGBM_TPU_PLATFORM``, the name the JAX package reads for
the same choice: unset, ``gpu`` or ``cuda`` -> ``cuda:0``, which raises
without a card; ``cpu`` -> the CPU; anything else raises. Only this
module reads it. The interpreter initialises CUDA on the thread of the
first call, and a C caller may call from others: each call makes the
device current for its work (``utils.device.on_device``).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import os
from typing import Dict

import numpy as np

from . import capi
from .utils.device import on_device, resolve_device
from .utils.log import LightGBMError

PLATFORM_ENV = "LGBM_TPU_PLATFORM"

_CT = {0: ctypes.c_float, 1: ctypes.c_double,
       2: ctypes.c_int32, 3: ctypes.c_int64}

_registry: Dict[int, object] = {}
# itertools.count is atomic under the GIL: concurrent C-side callers
# (the library drops the GIL between calls) never share a handle id
_next_id = itertools.count(1)


def device():
    """The device of ``LGBM_TPU_PLATFORM``: unset, gpu or cuda ->
    cuda:0 (raising without a card), cpu -> the CPU."""
    name = os.environ.get(PLATFORM_ENV, "").strip().lower()
    if name in ("", "gpu", "cuda"):
        return resolve_device(None)
    if name == "cpu":
        return resolve_device("cpu")
    raise LightGBMError(f"{PLATFORM_ENV}={name!r}: expected gpu, cuda or "
                        "cpu")


def _on_device(fn):
    """Run ``fn`` with the device of ``LGBM_TPU_PLATFORM`` current."""
    @functools.wraps(fn)
    def call(*args):
        dev = device()
        with on_device(dev):
            return fn(dev, *args)
    return call


def _put(obj) -> int:
    h = next(_next_id)
    _registry[h] = obj
    return h


def _get(h: int):
    return _registry[int(h)]


def free_handle(h: int) -> None:
    """Free a dataset or booster handle: what it holds, then its slot."""
    obj = _registry.pop(int(h), None)
    if isinstance(obj, capi._BoosterHandle):
        if obj.gbdt is not None:
            obj.gbdt._step = None       # the step-cache pool it looked up
        capi.LGBM_BoosterFree(obj)
    elif isinstance(obj, capi._DatasetHandle):
        capi.LGBM_DatasetFree(obj)


def _arr(ptr: int, n: int, dtype: int) -> np.ndarray:
    """Zero-copy numpy view of a C buffer."""
    if n == 0:
        return np.zeros(0, np.ctypeslib.as_ctypes_type(_CT[dtype]))
    p = ctypes.cast(int(ptr), ctypes.POINTER(_CT[dtype]))
    return np.ctypeslib.as_array(p, (int(n),))


def _mat(data, data_type, nrow, ncol, is_row_major) -> np.ndarray:
    """The caller's matrix as [nrow, ncol] rows in its own float type
    (f32 stays f32, as through ``capi``)."""
    flat = _arr(data, int(nrow) * int(ncol), data_type)
    m = (flat.reshape(nrow, ncol) if is_row_major
         else flat.reshape(ncol, nrow).T)
    return np.ascontiguousarray(
        m, np.float32 if int(data_type) == 0 else np.float64)


# --- Dataset ---------------------------------------------------------------

@_on_device
def dataset_from_csr(dev, indptr, indptr_type, indices, data, data_type,
                     nindptr, nelem, ncol, params, ref) -> int:
    ip = _arr(indptr, nindptr, indptr_type)
    ix = _arr(indices, nelem, 2)
    dv = _arr(data, nelem, data_type)
    ds = capi.LGBM_DatasetCreateFromCSR(
        ip, int(indptr_type), ix, dv, int(data_type), int(nindptr),
        int(nelem), int(ncol), parameters=params,
        reference=_get(ref) if ref else None, device=dev)
    return _put(ds)


@_on_device
def dataset_from_mat(dev, data, data_type, nrow, ncol, is_row_major,
                     params, ref) -> int:
    ds = capi.LGBM_DatasetCreateFromMat(
        _mat(data, data_type, nrow, ncol, is_row_major),
        parameters=params, reference=_get(ref) if ref else None,
        device=dev)
    return _put(ds)


@_on_device
def dataset_from_file(dev, filename, params, ref) -> int:
    ds = capi.LGBM_DatasetCreateFromFile(
        filename, parameters=params,
        reference=_get(ref) if ref else None, device=dev)
    return _put(ds)


@_on_device
def dataset_set_field(dev, h, name, data, n, dtype) -> None:
    capi.LGBM_DatasetSetField(_get(h), name, _arr(data, n, dtype).copy())


@_on_device
def dataset_num_data(dev, h) -> int:
    return int(capi.LGBM_DatasetGetNumData(_get(h)))


@_on_device
def dataset_num_feature(dev, h) -> int:
    return int(capi.LGBM_DatasetGetNumFeature(_get(h)))


# --- Booster ---------------------------------------------------------------

@_on_device
def booster_create(dev, train, params) -> int:
    return _put(capi.LGBM_BoosterCreate(_get(train), params))


@_on_device
def booster_from_modelfile(dev, filename, out_iters_ptr) -> int:
    bst = capi.LGBM_BoosterCreateFromModelfile(filename, device=dev)
    n = capi.LGBM_BoosterGetCurrentIteration(bst)
    _arr(out_iters_ptr, 1, 2)[0] = int(n)
    return _put(bst)


@_on_device
def booster_merge(dev, h, other) -> None:
    capi.LGBM_BoosterMerge(_get(h), _get(other))


@_on_device
def booster_add_valid(dev, h, valid) -> None:
    capi.LGBM_BoosterAddValidData(_get(h), _get(valid))


@_on_device
def booster_update(dev, h, out_ptr) -> None:
    fin = capi.LGBM_BoosterUpdateOneIter(_get(h))
    _arr(out_ptr, 1, 2)[0] = int(bool(fin))


@_on_device
def booster_refit(dev, h, leaf_preds, nrow, ncol) -> None:
    lp = _arr(leaf_preds, int(nrow) * int(ncol), 2).reshape(nrow, ncol)
    capi.LGBM_BoosterRefit(_get(h), lp)


@_on_device
def booster_calc_num_predict(dev, h, num_row, predict_type,
                             num_iteration) -> int:
    return int(capi.LGBM_BoosterCalcNumPredict(
        _get(h), int(num_row), int(predict_type), int(num_iteration)))


@_on_device
def booster_predict_csr(dev, h, indptr, indptr_type, indices, data,
                        data_type, nindptr, nelem, ncol, predict_type,
                        num_iteration, params, out_result) -> int:
    ip = _arr(indptr, nindptr, indptr_type)
    ix = _arr(indices, nelem, 2)
    dv = _arr(data, nelem, data_type)
    res = capi.LGBM_BoosterPredictForCSR(
        _get(h), ip, int(indptr_type), ix, dv, int(data_type),
        int(nindptr), int(nelem), int(ncol),
        predict_type=int(predict_type),
        num_iteration=int(num_iteration), parameter=params)
    flat = np.asarray(res, np.float64).reshape(-1)
    _arr(out_result, flat.size, 1)[:] = flat
    return int(flat.size)


@_on_device
def booster_predict_mat(dev, h, data, data_type, nrow, ncol, is_row_major,
                        predict_type, num_iteration, params,
                        out_result) -> int:
    m = _mat(data, data_type, nrow, ncol, is_row_major)
    res = capi.LGBM_BoosterPredictForMat(
        _get(h), m, data_type=int(data_type),
        predict_type=int(predict_type),
        num_iteration=int(num_iteration), parameter=params)
    out = np.asarray(res, np.float64).reshape(-1)
    _arr(out_result, out.size, 1)[:] = out
    return int(out.size)


@_on_device
def booster_save_model(dev, h, start_iteration, num_iteration,
                       filename) -> None:
    capi.LGBM_BoosterSaveModel(_get(h), num_iteration=int(num_iteration),
                               filename=filename,
                               start_iteration=int(start_iteration))


@_on_device
def booster_get_eval(dev, h, data_idx, out_results) -> int:
    pairs = capi.LGBM_BoosterGetEval(_get(h), int(data_idx))
    vals = np.asarray([v for _, v in pairs], np.float64)
    _arr(out_results, vals.size, 1)[:] = vals
    return int(vals.size)

"""Packed host->device calls: many arrays, ONE transfer.

Every host->device transfer has a fixed cost, so a kernel taking 20 array
arguments pays it 20 times before it can start. This
helper concatenates the byte views of all host arguments into a single
uint8 buffer, uploads it once, and bitcast-unpacks the arguments inside the
jitted consumer (static shapes/offsets — XLA sees plain slices).

Used by the keyframe-mapping stages (triangulation, fusion, local BA
assembly, point-attribute refresh) whose inputs are freshly gathered host
slices of the map SoA and cannot live on device between calls.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _unpack(buf: jax.Array, spec):
    """Unpack a flat uint8 device buffer into arrays per (shape, dtype) spec."""
    out = []
    off = 0
    for shape, dtype_str in spec:
        dt = np.dtype(dtype_str)
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * dt.itemsize
        chunk = buf[off:off + nbytes]
        off += nbytes
        if dt == np.bool_:
            arr = (chunk != 0).reshape(shape)
        elif dt.itemsize == 1:
            arr = chunk.reshape(shape)
        else:
            arr = jax.lax.bitcast_convert_type(
                chunk.reshape(count, dt.itemsize), jnp.dtype(dt)
            ).reshape(shape)
        out.append(arr)
    return out


def mirror_call(n_dev: int):
    """Like packed_call, but the first `n_dev` arguments are already
    device-resident arrays (a DeviceMap mirror) and pass straight through;
    only the remaining host arrays ship, as ONE packed transfer."""
    def deco(fn):
        cache: dict = {}
        _canon = {np.dtype(np.int64): np.int32,
                  np.dtype(np.uint64): np.uint32,
                  np.dtype(np.float64): np.float32}

        def call(*args, **static):
            dev = args[:n_dev]
            host = [np.ascontiguousarray(
                a.astype(_canon[a.dtype]) if getattr(a, "dtype", None) in _canon
                else a
            ) for a in map(np.asarray, args[n_dev:])]
            spec = tuple((a.shape, a.dtype.str) for a in host)
            key = (spec, tuple(sorted(static.items())))
            wrapped = cache.get(key)
            if wrapped is None:
                @jax.jit
                def wrapped(*dev_and_buf, spec=spec, static=dict(static)):
                    *d, buf = dev_and_buf
                    return fn(*d, *_unpack(buf, spec), **static)

                cache[key] = wrapped
            buf = (np.concatenate([h.view(np.uint8).reshape(-1) for h in host])
                   if host else np.zeros(0, np.uint8))
            return wrapped(*dev, jnp.asarray(buf))

        call.__name__ = getattr(fn, "__name__", "mirror_call")
        return call

    return deco


def packed_call(fn):
    """Wrap `fn(*arrays, **static_kwargs)` so all array arguments ship as
    ONE host->device transfer. `fn` must be jit-safe; a jitted wrapper is
    compiled per (shapes, dtypes, static kwargs) signature."""
    cache: dict = {}

    _canon = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
              np.dtype(np.float64): np.float32}

    def call(*arrays, **static):
        # canonicalize 64-bit dtypes (jax runs x64-disabled; a 64-bit buffer
        # cannot bitcast to the canonical 32-bit type)
        host = [np.ascontiguousarray(
            a.astype(_canon[a.dtype]) if getattr(a, "dtype", None) in _canon
            else a
        ) for a in map(np.asarray, arrays)]
        spec = tuple((a.shape, a.dtype.str) for a in host)
        key = (spec, tuple(sorted(static.items())))
        wrapped = cache.get(key)
        if wrapped is None:
            @jax.jit
            def wrapped(buf, spec=spec, static=dict(static)):
                return fn(*_unpack(buf, spec), **static)

            cache[key] = wrapped
        if host:
            buf = np.concatenate(
                [h.view(np.uint8).reshape(-1) for h in host]
            )
        else:
            buf = np.zeros(0, np.uint8)
        return wrapped(jnp.asarray(buf))

    call.__name__ = getattr(fn, "__name__", "packed_call")
    return call

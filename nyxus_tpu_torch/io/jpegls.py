# Copied verbatim from nyxus_tpu/io/jpegls.py; pinned by tests/test_torch_tables.py.
"""JPEG-LS (ITU-T T.87) codec via the system CharLS 2.x shared library.

The reference decodes JPEG-LS DICOM through DCMTK's CharLS bundle
(reference: src/nyx/nyxus_dicom_loader.h:4-19 registers the djdecode/
dcmjpls codecs).  This build binds the distro's libcharls.so.2 directly
with ctypes -- no Python package needed.  ``available()`` is False when the
library is absent and callers fall back to a clear unsupported error.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_tried = False


class _FrameInfo(ctypes.Structure):
    # charls/public_types.h charls_frame_info
    _fields_ = [("width", ctypes.c_uint32), ("height", ctypes.c_uint32),
                ("bits_per_sample", ctypes.c_int32),
                ("component_count", ctypes.c_int32)]


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for name in ("libcharls.so.2", "libCharLS.so.2", "libcharls.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.charls_jpegls_decoder_create.restype = ctypes.c_void_p
        lib.charls_jpegls_decoder_set_source_buffer.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.charls_jpegls_decoder_read_header.argtypes = [ctypes.c_void_p]
        lib.charls_jpegls_decoder_get_frame_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_FrameInfo)]
        lib.charls_jpegls_decoder_get_destination_size.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.charls_jpegls_decoder_decode_to_buffer.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_uint32]
        lib.charls_jpegls_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.charls_jpegls_encoder_create.restype = ctypes.c_void_p
        lib.charls_jpegls_encoder_set_frame_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_FrameInfo)]
        lib.charls_jpegls_encoder_set_destination_buffer.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.charls_jpegls_encoder_encode_from_buffer.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_uint32]
        lib.charls_jpegls_encoder_get_bytes_written.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
        lib.charls_jpegls_encoder_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        break
    return _lib


def available() -> bool:
    return _load() is not None


def _check(rc, what):
    if rc != 0:
        raise ValueError("CharLS %s failed (code %d)" % (what, rc))


def decode(buf: bytes):
    """Decode one JPEG-LS codestream -> 2D numpy array (grayscale)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libcharls not available")
    dec = lib.charls_jpegls_decoder_create()
    try:
        src = ctypes.create_string_buffer(buf, len(buf))
        _check(lib.charls_jpegls_decoder_set_source_buffer(
            dec, src, len(buf)), "set_source")
        _check(lib.charls_jpegls_decoder_read_header(dec), "read_header")
        fi = _FrameInfo()
        _check(lib.charls_jpegls_decoder_get_frame_info(
            dec, ctypes.byref(fi)), "frame_info")
        if fi.component_count != 1:
            raise ValueError("only grayscale JPEG-LS is supported")
        size = ctypes.c_size_t()
        _check(lib.charls_jpegls_decoder_get_destination_size(
            dec, 0, ctypes.byref(size)), "dest_size")
        out = ctypes.create_string_buffer(size.value)
        _check(lib.charls_jpegls_decoder_decode_to_buffer(
            dec, out, size.value, 0), "decode")
        dt = np.uint8 if fi.bits_per_sample <= 8 else np.uint16
        arr = np.frombuffer(out.raw, dt,
                            fi.width * fi.height).reshape(fi.height,
                                                          fi.width)
        return arr.copy()
    finally:
        lib.charls_jpegls_decoder_destroy(dec)


def encode(arr: np.ndarray, bits: int = None) -> bytes:
    """Encode a 2D grayscale array losslessly (test-data generator and
    writer support)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libcharls not available")
    arr = np.ascontiguousarray(arr)
    if bits is None:
        bits = 8 if arr.dtype.itemsize == 1 else 16
    fi = _FrameInfo(arr.shape[1], arr.shape[0], bits, 1)
    enc = lib.charls_jpegls_encoder_create()
    try:
        _check(lib.charls_jpegls_encoder_set_frame_info(
            enc, ctypes.byref(fi)), "set_frame_info")
        cap = arr.nbytes * 2 + 1024
        dst = ctypes.create_string_buffer(cap)
        _check(lib.charls_jpegls_encoder_set_destination_buffer(
            enc, dst, cap), "set_dest")
        _check(lib.charls_jpegls_encoder_encode_from_buffer(
            enc, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes, 0),
            "encode")
        n = ctypes.c_size_t()
        _check(lib.charls_jpegls_encoder_get_bytes_written(
            enc, ctypes.byref(n)), "bytes_written")
        return dst.raw[:n.value]
    finally:
        lib.charls_jpegls_encoder_destroy(enc)

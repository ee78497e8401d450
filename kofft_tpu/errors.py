"""Typed error taxonomy for kofft-tpu.

Mirrors the reference's exhaustive ``FftError`` enum (reference:
``src/fft.rs:446-454``: EmptyInput, NonPowerOfTwoNoStd, MismatchedLengths,
InvalidStride, InvalidHopSize, InvalidValue). On the device, in-kernel errors are
unavailable, so every validation happens eagerly at the Python layer before
any device launch (see SURVEY.md §5.3).
"""

from __future__ import annotations


class KofftError(ValueError):
    """Base class for all kofft-tpu errors."""


class EmptyInputError(KofftError):
    """Input signal has zero length (reference ``FftError::EmptyInput``)."""

    def __init__(self, msg: str = "input must be non-empty"):
        super().__init__(msg)


class MismatchedLengthsError(KofftError):
    """Two buffers that must agree in length do not
    (reference ``FftError::MismatchedLengths``)."""


class InvalidStrideError(KofftError):
    """A stride parameter is zero/negative or inconsistent with the buffer
    (reference ``FftError::InvalidStride``)."""


class InvalidHopSizeError(KofftError):
    """STFT hop size is zero or larger than the window
    (reference ``FftError::InvalidHopSize``)."""


class InvalidValueError(KofftError):
    """A parameter value is out of its legal range
    (reference ``FftError::InvalidValue``)."""


def require(cond: bool, exc: type[KofftError], msg: str) -> None:
    """Eager validation helper — raises *before* tracing/launch."""
    if not cond:
        raise exc(msg)

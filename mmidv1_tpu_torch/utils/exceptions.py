"""Typed exception hierarchy.

Mirrors the reference's 9-type exception taxonomy rooted at ``ModelException``
(reference: ``include/exceptions/Exceptions.hpp:18-174``) plus the CSV reader's
error-typed exception (``include/utils/CSVReadException.hpp``); a copy of
``mmidv1_tpu/utils/exceptions.py``. Host-side only: inside batched tensor code,
failures are expressed as masks / lowest() objective values, so these exceptions
surface at configuration/IO boundaries exactly where the C++ ones do.
"""

from __future__ import annotations

import enum


class ModelException(Exception):
    """Root of the taxonomy. Carries the originating component name."""

    def __init__(self, where: str, message: str):
        self.where = where
        self.message = message
        super().__init__(f"[{where}] {message}")


class InvalidParameterException(ModelException):
    pass


class SimulationException(ModelException):
    pass


class ModelConstructionException(ModelException):
    pass


class InterventionException(ModelException):
    pass


class FileIOException(ModelException):
    pass


class DataFormatException(ModelException):
    pass


class InvalidResultException(ModelException):
    pass


class OutOfRangeException(ModelException):
    pass


class CSVReadError(enum.Enum):
    FILE_OPEN = "FileOpenError"
    NOT_ENOUGH_ROWS = "NotEnoughRows"
    NOT_ENOUGH_COLUMNS = "NotEnoughColumns"
    INVALID_NUMBER_FORMAT = "InvalidNumberFormat"


class CSVReadException(ModelException):
    """CSV parsing failure with a typed error kind
    (reference ``CSVReadException.{hpp,cpp}``)."""

    def __init__(self, error_type: CSVReadError, where: str, message: str):
        self.error_type = error_type
        super().__init__(where, f"{error_type.value}: {message}")

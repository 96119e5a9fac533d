"""Exceptions, logging, file helpers and device selection of the port."""

from .exceptions import (CSVReadException, DataFormatException,
                         FileIOException, InterventionException,
                         InvalidParameterException, InvalidResultException,
                         ModelConstructionException, ModelException,
                         OutOfRangeException, SimulationException)
from .logging import Logger, get_logger
from . import fileutils

__all__ = [
    "ModelException", "InvalidParameterException", "SimulationException",
    "ModelConstructionException", "InterventionException", "FileIOException",
    "DataFormatException", "InvalidResultException", "OutOfRangeException",
    "CSVReadException", "get_logger", "Logger", "fileutils",
]

from .core import WCS, WCSCelestialError
from .spectral import (convert_spectral_axis, determine_ctype_from_vconv,
                       determine_vconv_from_ctype, air_to_vac, vac_to_air,
                       air_to_vac_deriv, spectral_value_transform)
from . import projections

__all__ = ["WCS", "WCSCelestialError", "convert_spectral_axis",
           "determine_ctype_from_vconv", "determine_vconv_from_ctype",
           "air_to_vac", "vac_to_air", "air_to_vac_deriv",
           "spectral_value_transform", "projections"]

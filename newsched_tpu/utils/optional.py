"""Imports of packages that only some features need."""

from __future__ import annotations

import importlib


def require(module: str, package: str, feature: str):
    """Import `module`, or raise an ImportError that names the package to
    install and the feature that needs it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{feature} needs the '{package}' package, which is not "
            f"installed (pip install {package})") from e

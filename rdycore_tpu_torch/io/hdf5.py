"""h5py, imported where an HDF5 file is read or written, never at import.

HDF5 checkpoints, XDMF and CGNS output need h5py, which a machine may
lack. There they fail with a ConfigError naming h5py and the format to use
instead; nothing switches format silently.
"""

from __future__ import annotations

from ..config.schema import ConfigError


def require_h5py(what: str, instead: str):
    """The h5py module; a ConfigError naming `what` needs it and `instead`
    where it does not import."""
    try:
        import h5py
    except ImportError as e:
        raise ConfigError(
            f"{what} needs h5py, which does not import here ({e}); use "
            f"{instead}"
        ) from e
    return h5py


def check_hdf5(config) -> None:
    """Raise at setup for each part of a deck that needs h5py where it is
    absent: HDF5 checkpoints, XDMF or CGNS output, an HDF5 restart file."""
    if config.checkpoint.interval and config.checkpoint.format == "hdf5":
        require_h5py("checkpoint.format: hdf5", "checkpoint.format: binary")
    if config.output.format in ("xdmf", "cgns"):
        require_h5py(f"output.format: {config.output.format}",
                     "output.format: binary")
    if config.restart.file and not config.restart.file.endswith(".bin"):
        require_h5py(f"restart.file: {config.restart.file} (HDF5)",
                     "a binary (.bin) checkpoint")

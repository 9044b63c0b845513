# Copy of tntblast_tpu/thermo/__init__.py with the package name changed.
from .santa_lucia import ThermoParams, build_tables, update_dp_param  # noqa: F401

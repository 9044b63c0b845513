# Copy of tntblast_tpu/utils/__init__.py with the package name changed.

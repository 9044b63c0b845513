# Copy of tntblast_tpu/search/__init__.py with the package name changed.

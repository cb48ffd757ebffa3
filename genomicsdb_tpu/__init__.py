"""genomicsdb_tpu: variant-array engine on JAX/XLA.

The flattened genome axis spans ~3.1e9 positions (> int32), so 64-bit JAX
types are enabled package-wide.  Per-block kernels still use int32 for field
data; only coordinates are int64.
"""

try:
    import jax

    jax.config.update("jax_enable_x64", True)
except ImportError:  # pure-host usage
    pass

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (avoids importing the full engine at package
    import time):

        from genomicsdb_tpu import VidMapper, import_callsets, ...
    """
    api = {
        "VidMapper": ("genomicsdb_tpu.core.vid", "VidMapper"),
        "QueryParams": ("genomicsdb_tpu.core.config", "QueryParams"),
        "ImportParams": ("genomicsdb_tpu.core.config", "ImportParams"),
        "import_callsets": ("genomicsdb_tpu.store.import_pipeline",
                            "import_callsets"),
        "StreamingImporter": ("genomicsdb_tpu.store.streaming_import",
                              "StreamingImporter"),
        "FeatureReader": ("genomicsdb_tpu.query.stream", "FeatureReader"),
        "CombinedRecordStream": ("genomicsdb_tpu.query.stream",
                                 "CombinedRecordStream"),
        "driver": ("genomicsdb_tpu.query.driver", None),
    }
    if name in api:
        import importlib
        mod, attr = api[name]
        m = importlib.import_module(mod)
        return m if attr is None else getattr(m, attr)
    raise AttributeError(f"module 'genomicsdb_tpu' has no attribute "
                         f"{name!r}")

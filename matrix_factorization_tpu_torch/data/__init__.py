"""Rating-file loading and the native host helpers (``data.loader``)."""

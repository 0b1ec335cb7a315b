"""Rating-file loading and the native host helpers (``data.loader``), and
synthetic rating data (``data.synthetic``)."""

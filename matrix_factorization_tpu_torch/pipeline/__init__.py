"""Batch pipeline CLIs (``python -m matrix_factorization_tpu_torch.pipeline.<stage>``),
the PyTorch port of ``matrix_factorization_tpu/pipeline``.

Stateless file-to-file transforms over the ``data/ features/ artifacts/``
directory contract, mirroring the reference's
``project_template/pipeline/`` stages P2-P16 (SURVEY.md §2.3). Every stage
takes ``--platform {cpu,cuda}``; without it the stage runs on the GPU and
raises when there is none. Each ``main()`` reads and writes the files
around a function that does the stage's work on frames.
"""

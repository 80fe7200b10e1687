"""Comparisons that decide ``correct`` for the traffic mixes that name one
(``"check": "<name>"`` in ``benchmark/traffic/<mix>.json`` is
``benchmark/checks/<name>.py``); a mix that names none is judged by
``benchmark/check.py``. Each module exposes ``LIMITS``, ``compare(answers,
obstacle, config, traffic, device)`` and ``verdict(numbers)``, and may
expose ``control(...)``, which :mod:`benchmark.control` runs."""

"""Result caches: plan fingerprints and segment tokens (keys.py), the
segment partial-result cache (partial.py) and the broker result cache of
multi-stage statements (results.py)."""

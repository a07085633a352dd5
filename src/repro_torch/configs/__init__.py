"""The LM architectures behind ``--arch``: one ``ModelConfig`` each, a copy of
``repro.configs``; :mod:`.registry` maps the names."""

"""The LM of ``repro.models`` on PyTorch tensors: its configuration, the
layers of every family, model assembly and the conversion of the
reference's parameters (:mod:`.convert`)."""

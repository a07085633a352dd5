"""The LM of ``repro.models`` on PyTorch tensors: its configuration, the
dense-attention layers, model assembly and the conversion of the
reference's parameters (:mod:`.convert`)."""

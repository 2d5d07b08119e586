"""Interchange formats of the port (mirrors arrow_go_tpu.interop):
`protowire`, the protobuf wire format by hand (for compute/substrait.py),
`arrjson`, the Arrow integration-test JSON over HostBatches, and
`pyarrow_interop`, HostArrays and HostBatches to and from pyarrow (which
it imports at its first call). The C data interface is
`arrow_go_tpu_torch.cdata`."""

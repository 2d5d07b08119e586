"""Interchange formats of the port (mirrors arrow_go_tpu.interop):
`protowire`, the protobuf wire format by hand (for compute/substrait.py),
and `arrjson`, the Arrow integration-test JSON over HostBatches. The
C data interface is `arrow_go_tpu_torch.cdata`."""

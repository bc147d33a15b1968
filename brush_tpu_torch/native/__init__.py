"""The port's native components, built with g++ only when asked
(`python -m brush_tpu_torch.native.build`): the COLMAP binary parser and
the C ABI library. Importing this package builds and loads nothing."""

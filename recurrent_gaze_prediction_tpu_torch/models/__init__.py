"""Gaze models of the port (the ten families of the registry), ShallowNet,
the C3D tower, the raw-video pipeline and the carried-state streaming
steps."""

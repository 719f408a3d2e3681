"""Helpers of the port: weight porting, checkpoint manifests, devices, trackers and the
preprocessing of control, flow and motion inputs."""

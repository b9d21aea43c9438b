"""Visualization: thread-safe scene store + WebGL HTML / PNG exports."""

from tpu3d_torch.viz.viewer import SceneViewer

__all__ = ["SceneViewer"]

"""PyTorch + CUDA port of the SegFold reproduction, for NVIDIA Hopper.

Mirrors the layout of ``repro`` (the JAX/Pallas reference, which this
package never imports): ``configs``, ``core`` (patterns and schedules),
``kernels`` (hand-written CUDA kernels beside their plain torch versions),
``api`` (plan / execute), ``models``, ``runtime`` (serving) and ``launch``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

"""Traffic generators by file: a traffic file that names a "generator" is
made by ``generators/<generator>.py`` (slambench/harness/files.py); one
that names none by slambench/harness/traffic.py's renderer. A generator
file provides:

- ``generate(traffic, camera, seed, device)``: every agent's inputs of the
  traffic file (the parsed JSON object, "generator" key included), made
  from the seed alone on `device`, the same seed giving the same inputs,
  with the port's CameraConfig `camera`. It returns a list, one entry an
  agent, of ``traffic.AgentFrames`` or of a type of its own with more
  fields (IMU samples, say), which only its system's driver reads. Make
  the inputs on the device in a few large calls: their making counts as
  set-up.
"""

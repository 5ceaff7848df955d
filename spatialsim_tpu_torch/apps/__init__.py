"""Interactive applications (reference L4): live boids and N-body viewers.

Requires a display + OpenGL; every entry point degrades gracefully to an
explanatory message on headless machines (the offline record → playback →
export pipeline is the headless path).
"""

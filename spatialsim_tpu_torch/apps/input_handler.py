"""Keyboard/mouse camera controls.

One parameterized handler replacing the reference's duplicated pair
(``core/input_handler.py`` / ``core/nbody_input_handler.py`` — verbatim
twins per SURVEY.md C14).  Bindings preserved: WASD rotate, Q/E zoom,
mouse wheel smooth-zoom, left-drag rotate.
"""

from __future__ import annotations


class InputHandler:
    def __init__(self, camera, rotate_speed=60.0, zoom_speed=100.0,
                 mouse_sensitivity=0.3, wheel_zoom=50.0):
        self.camera = camera
        self.rotate_speed = rotate_speed
        self.zoom_speed = zoom_speed
        self.mouse_sensitivity = mouse_sensitivity
        self.wheel_zoom = wheel_zoom
        self._dragging = False
        self._last_mouse = (0, 0)

    def handle_event(self, event) -> None:
        import pygame
        if event.type == pygame.MOUSEBUTTONDOWN and event.button == 1:
            self._dragging = True
            self._last_mouse = event.pos
        elif event.type == pygame.MOUSEBUTTONUP and event.button == 1:
            self._dragging = False
        elif event.type == pygame.MOUSEMOTION and self._dragging:
            dx = event.pos[0] - self._last_mouse[0]
            dy = event.pos[1] - self._last_mouse[1]
            self._last_mouse = event.pos
            self.camera.rotate(dx * self.mouse_sensitivity,
                               -dy * self.mouse_sensitivity)
        elif event.type == pygame.MOUSEWHEEL:
            self.camera.zoom(-event.y * self.wheel_zoom)

    def update(self, dt: float) -> None:
        import pygame
        keys = pygame.key.get_pressed()
        d_theta = (keys[pygame.K_d] - keys[pygame.K_a]) \
            * self.rotate_speed * dt
        d_phi = (keys[pygame.K_w] - keys[pygame.K_s]) \
            * self.rotate_speed * dt
        if d_theta or d_phi:
            self.camera.rotate(d_theta, d_phi)
        zoom = (keys[pygame.K_e] - keys[pygame.K_q]) * self.zoom_speed * dt
        if zoom:
            self.camera.zoom(zoom)
        self.camera.update(dt)

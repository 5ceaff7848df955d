"""World-space helpers for the GL viewers: bounding grid + HUD text.

Reference equivalents: immediate-mode wireframe cube
(``rendering/grid.py:23-44``) and pygame-font → ``glDrawPixels`` HUD
(``rendering/text.py:14-48``).
"""

from __future__ import annotations


class Grid:
    """Wireframe cube of half-extent ``size`` centred at the origin."""

    def __init__(self, size=500.0, color=(0.08, 0.08, 0.12)):
        self.size = size
        self.color = color

    def draw(self) -> None:
        from OpenGL.GL import (glBegin, glColor3f, glEnd, glVertex3f,
                               GL_LINES)
        s = self.size
        corners = [(x, y, z) for x in (-s, s) for y in (-s, s)
                   for z in (-s, s)]
        edges = [(a, b) for a in range(8) for b in range(a + 1, 8)
                 if bin(a ^ b).count("1") == 1]
        glColor3f(*self.color)
        glBegin(GL_LINES)
        for a, b in edges:
            glVertex3f(*corners[a])
            glVertex3f(*corners[b])
        glEnd()


class TextRenderer:
    """HUD text: render with pygame's font, blit via glDrawPixels."""

    def __init__(self, size=18, color=(0.7, 0.8, 0.9)):
        import pygame
        pygame.font.init()
        self.font = pygame.font.SysFont("monospace", size)
        self.color = tuple(int(c * 255) for c in color)

    def draw_text(self, text: str, x: int, y: int,
                  window_size=(1280, 720)) -> None:
        import pygame
        from OpenGL.GL import (
            glMatrixMode, glPushMatrix, glPopMatrix, glLoadIdentity,
            glOrtho, glRasterPos2i, glDrawPixels, GL_PROJECTION,
            GL_MODELVIEW, GL_RGBA, GL_UNSIGNED_BYTE)
        surface = self.font.render(text, True, self.color)
        data = pygame.image.tostring(surface, "RGBA", True)
        w, h = surface.get_size()
        glMatrixMode(GL_PROJECTION)
        glPushMatrix()
        glLoadIdentity()
        glOrtho(0, window_size[0], 0, window_size[1], -1, 1)
        glMatrixMode(GL_MODELVIEW)
        glPushMatrix()
        glLoadIdentity()
        glRasterPos2i(x, window_size[1] - y - h)
        glDrawPixels(w, h, GL_RGBA, GL_UNSIGNED_BYTE, data)
        glPopMatrix()
        glMatrixMode(GL_PROJECTION)
        glPopMatrix()
        glMatrixMode(GL_MODELVIEW)

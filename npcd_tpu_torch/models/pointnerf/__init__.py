"""PointNeRF eval render."""

"""Device discovery."""

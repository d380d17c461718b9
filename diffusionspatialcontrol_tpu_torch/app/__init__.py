"""The app layer: ``ModelManager``, ``inference()`` and the HTTP server."""

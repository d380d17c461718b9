"""Host-side native code: the image codec binding."""

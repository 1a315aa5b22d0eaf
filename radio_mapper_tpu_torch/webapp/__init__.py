"""Web dashboard: Leaflet map + live API proxy (aiohttp, imported lazily)."""

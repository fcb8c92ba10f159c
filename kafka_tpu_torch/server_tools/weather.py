"""Weather lookup tool (Open-Meteo geocode + forecast).

Parity: reference server_tools/weather.py:13-112 — the no-auth live-API
demo tool.  Network failures return an error string (tool errors are data
the model can react to), so the tool is safe to register in offline
environments.
"""

from __future__ import annotations

import json

from ..tools.types import Tool

GEOCODE_URL = "https://geocoding-api.open-meteo.com/v1/search"
FORECAST_URL = "https://api.open-meteo.com/v1/forecast"

WEATHER_CODES = {
    0: "clear sky", 1: "mainly clear", 2: "partly cloudy", 3: "overcast",
    45: "fog", 48: "depositing rime fog", 51: "light drizzle",
    53: "drizzle", 55: "dense drizzle", 61: "light rain", 63: "rain",
    65: "heavy rain", 71: "light snow", 73: "snow", 75: "heavy snow",
    80: "rain showers", 81: "heavy rain showers", 95: "thunderstorm",
}


def weather_tool() -> Tool:
    async def get_weather(location: str) -> str:
        try:
            import httpx

            async with httpx.AsyncClient(timeout=10) as client:
                geo = await client.get(
                    GEOCODE_URL, params={"name": location, "count": 1}
                )
                geo.raise_for_status()
                results = geo.json().get("results") or []
                if not results:
                    return f"No location found for {location!r}."
                place = results[0]
                fc = await client.get(
                    FORECAST_URL,
                    params={
                        "latitude": place["latitude"],
                        "longitude": place["longitude"],
                        "current": "temperature_2m,weather_code,wind_speed_10m",
                    },
                )
                fc.raise_for_status()
                cur = fc.json().get("current", {})
            desc = WEATHER_CODES.get(cur.get("weather_code"), "unknown")
            return json.dumps({
                "location": place.get("name", location),
                "country": place.get("country"),
                "temperature_c": cur.get("temperature_2m"),
                "conditions": desc,
                "wind_kmh": cur.get("wind_speed_10m"),
            })
        except Exception as e:
            return f"Weather lookup failed: {type(e).__name__}: {e}"

    return Tool(
        name="get_weather",
        description="Get current weather for a location by name.",
        parameters={
            "type": "object",
            "properties": {"location": {"type": "string"}},
            "required": ["location"],
        },
        handler=get_weather,
    )

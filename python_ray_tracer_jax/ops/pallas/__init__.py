from .render_pallas import render_image_pallas, render_image_fast

"""Object-perception template banks (original text).

Parity: single_object_perception_engine.py:25-122 — 30 task descriptions
(ASK_DESCRIPTION), 30 question templates ({dimension}, {object_category}),
30 answer templates ({dimension}, {value_mm}, {object_category}).
"""

from . import expand

TASK_DESCRIPTION = expand(
    ["The scene is static across all provided views.",
     "Every image shows the same unchanged scene.",
     "Assume the scene did not change between the captures.",
     "All pictures come from one still scene.",
     "The photographs depict a single frozen scene.",
     "Nothing in the scene moved between these shots."],
    ["Combine the evidence from all images to measure the asked spatial "
     "property.",
     "Integrate information across every view to find the requested "
     "dimension.",
     "Use all of the views together to derive the spatial measurement.",
     "Aggregate what each image shows to compute the asked quantity.",
     "Reason jointly over the images to obtain the answer."],
    limit=30,
)

QUESTION_TEMPLATES = expand(
    ["What is the {dimension} in millimeters of the {object_category}",
     "Measure the {dimension} (mm) of the {object_category}",
     "Estimate, in millimeters, the {dimension} of the {object_category}",
     "Work out the {dimension} in mm of the {object_category}",
     "Give the {dimension}, in millimeters, of the {object_category}",
     "Determine the {dimension} (in mm) of the {object_category}"],
    ["that appears in all of these images?",
     "commonly visible across the provided views?",
     "that every one of these pictures shows?",
     "seen in common throughout these images?",
     "visible in each of the given views?"],
    limit=30,
)

ANSWER_TEMPLATES = expand(
    ["The {dimension} comes to", "Its {dimension} measures",
     "The {object_category}'s {dimension} is about",
     "I put the {dimension} at", "The measured {dimension} is",
     "That {object_category} has a {dimension} of roughly"],
    ["`{value_mm}` millimeters.", "`{value_mm}` mm.",
     "`{value_mm}` mm overall.", "approximately `{value_mm}` millimeters.",
     "`{value_mm}` millimeters in total."],
    limit=30,
)
